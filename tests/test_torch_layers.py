"""The port's configs, parameter specs, weight bridge and layer primitives
against the JAX reference.

Inputs are made with numpy from a seed and fed to both frameworks; weights
cross through ``repro_torch.models.params.from_jax``.  Tolerances are the
reference suite's (bf16 2e-2); where the port reproduces the reference's
rounding points exactly, the test says so and asserts bit equality.
Every test that needs the reference starts from ``pytest.importorskip``,
so on a machine without JAX only the port-only tests run.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ALL_ARCHS as T_ARCHS
from repro_torch.configs import reduced as t_reduced
from repro_torch.models import layers as TL
from repro_torch.models import params as TP

ARCH = "deepseek-7b"
DENSE = [n for n, c in T_ARCHS.items() if c.family == "dense"]
BF16_TOL = 2e-2


@pytest.fixture(scope="module")
def ref():
    """(reference cfg, reference params, bridged port params)."""
    jax = pytest.importorskip("jax")
    from repro.configs import ALL_ARCHS, reduced
    from repro.models import build
    cfg = reduced(ALL_ARCHS[ARCH])
    params = build(cfg).init_params(jax.random.PRNGKey(0))
    return cfg, params, TP.from_jax(jax.tree.map(np.asarray, params))


def _bf16_pair(arr):
    """The same bf16 values as a JAX array and a torch tensor."""
    import jax.numpy as jnp
    j = jnp.asarray(arr, jnp.bfloat16)
    return j, TP.from_jax({"x": np.asarray(j)})["x"]


def _np(x):
    """float32 numpy of a JAX array or torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype("float32"))


# ------------------------------------------------------------------ configs


@pytest.mark.parametrize("name", sorted(T_ARCHS))
def test_configs_match_reference(name):
    """The copied configs (and their reduced forms) equal the reference's
    field for field."""
    pytest.importorskip("jax")
    from repro.configs import ALL_ARCHS, reduced
    assert dataclasses.asdict(T_ARCHS[name]) == dataclasses.asdict(
        ALL_ARCHS[name])
    assert dataclasses.asdict(t_reduced(T_ARCHS[name])) == dataclasses.asdict(
        reduced(ALL_ARCHS[name]))


@pytest.mark.parametrize("name", DENSE)
def test_param_specs_match_reference(name):
    """The dense spec tree has the reference's keys, shapes, axes, dtypes
    and initializers at full width (declaration only, nothing allocated)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import ALL_ARCHS
    from repro.models import stack

    def flat(tree, path=()):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(flat(v, path + (k,)))
            return out
        return {path: (tuple(tree.shape), tuple(tree.axes),
                       jnp.dtype(tree.dtype).name if not isinstance(
                           tree.dtype, torch.dtype)
                       else str(tree.dtype).replace("torch.", ""),
                       tree.init)}

    want = flat(stack.param_specs(ALL_ARCHS[name]))
    got = flat(TP.param_specs(T_ARCHS[name]))
    assert got == want
    assert T_ARCHS[name].param_count() == stack.param_count(ALL_ARCHS[name])


def test_param_specs_refuse_other_families():
    with pytest.raises(ValueError, match="dense"):
        TP.param_specs(T_ARCHS["mamba2-2.7b"])


@pytest.mark.parametrize("name", [n for n, c in T_ARCHS.items() if c.n_heads])
def test_head_geom_matches_reference(name):
    pytest.importorskip("jax")
    from repro.configs import ALL_ARCHS
    from repro.models.layers import head_geom
    assert (dataclasses.asdict(TL.head_geom(T_ARCHS[name]))
            == dataclasses.asdict(head_geom(ALL_ARCHS[name], 1)))


# ------------------------------------------------------------------ weights


def test_weight_bridge_is_bit_exact(ref):
    """Every leaf of the reference's init pytree crosses unchanged: same
    shape, same dtype, same bits."""
    import jax
    _, params, tparams = ref
    flat_ref = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat_ref) == len(TP.leaves(tparams))
    for path, leaf in flat_ref:
        t = tparams
        for k in path:
            t = t[k.key]
        a = np.asarray(leaf)
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype).replace("torch.", "") == a.dtype.name, path
        bits = 16 if a.dtype.itemsize == 2 else 32
        ia = np.array(a).view(np.int16 if bits == 16 else np.int32)
        it = t.view(torch.int16 if bits == 16 else torch.int32).numpy()
        assert (ia == it).all(), path


def test_initialize_uses_reference_scales():
    """Seeded init on the CPU: norms are ones, the embedding's spread is
    d**-0.5, projections fan_in**-0.5, one seed gives one set of weights."""
    cfg = t_reduced(T_ARCHS[ARCH])
    specs = TP.param_specs(cfg)
    p1 = TP.initialize(specs, torch.Generator().manual_seed(3), "cpu")
    p2 = TP.initialize(specs, torch.Generator().manual_seed(3), "cpu")
    for a, b in zip(TP.leaves(p1), TP.leaves(p2)):
        assert torch.equal(a, b)
    assert torch.equal(p1["final_norm"], torch.ones(cfg.d_model,
                                                    dtype=torch.bfloat16))
    tok = p1["embed"]["tok"].float()
    assert abs(float(tok.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    wq = p1["layers"]["attn"]["wq"].float()
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert wq.dtype == torch.float32 and p1["layers"]["attn"]["wq"].dtype == torch.bfloat16


# ------------------------------------------------------------------- layers


def test_rmsnorm_matches_reference(ref):
    from repro.models import layers as JL
    cfg, params, tparams = ref
    xj, xt = _bf16_pair(np.random.default_rng(0).standard_normal(
        (3, 5, cfg.d_model)))
    got = TL.rmsnorm(tparams["layers"]["ln1"][0], xt, cfg.norm_eps)
    want = JL.rmsnorm(params["layers"]["ln1"][0], xj, cfg.norm_eps)
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0, 0.0])
def test_rope_matches_reference(ref, theta):
    """Half-split rotary embedding, fp32 angles, one cast back."""
    from repro.models import layers as JL
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    xj, xt = _bf16_pair(rng.standard_normal((3, 5, 4, 32)))
    pos = rng.integers(0, 1000, size=(3, 5))
    got = TL.rope(xt, torch.tensor(pos), theta)
    want = JL.rope(xj, jnp.asarray(pos), theta)
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_swiglu_matches_reference(ref):
    import jax
    from repro.models import layers as JL
    cfg, params, tparams = ref
    xj, xt = _bf16_pair(np.random.default_rng(2).standard_normal(
        (3, 5, cfg.d_model)))
    mlp_j = jax.tree.map(lambda a: a[1], params["layers"]["mlp"])
    mlp_t = TP.tree_map(lambda a: a[1], tparams["layers"]["mlp"])
    np.testing.assert_allclose(_np(TL.swiglu(mlp_t, xt)),
                               _np(jax.jit(JL.swiglu)(mlp_j, xj)),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_silu_rounds_like_the_reference(ref):
    """``jax.nn.silu`` on bf16 rounds after each op of
    ``x * (1 / (1 + exp(-x)))``; the port's ``silu`` reproduces that bit
    for bit (``F.silu`` rounds once and would not)."""
    import jax
    xj, xt = _bf16_pair(3 * np.random.default_rng(3).standard_normal(4096))
    assert (_np(TL.silu(xt)) == _np(jax.jit(jax.nn.silu)(xj))).all()


def test_embed_and_logits_match_reference(ref):
    from repro.models import layers as JL
    import jax.numpy as jnp
    cfg, params, tparams = ref
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, size=(2, 6))
    x_t = TL.embed_tokens(tparams["embed"], torch.tensor(toks))
    x_j = JL.embed_tokens(params["embed"], jnp.asarray(toks))
    assert (_np(x_t) == _np(x_j)).all()
    lt = TL.logits_from(tparams["embed"], cfg, x_t)
    lj = JL.logits_from(params["embed"], cfg, x_j)
    assert lt.dtype == torch.float32 and lt.shape[-1] == cfg.padded_vocab
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=BF16_TOL,
                               atol=BF16_TOL)
    assert (lt.argmax(-1).numpy() == np.asarray(lj).argmax(-1)).all()


def test_tied_logits_use_the_embedding_table():
    cfg = dataclasses.replace(t_reduced(T_ARCHS[ARCH]), tie_embeddings=True)
    p = TP.initialize(TP.embed_specs(cfg), torch.Generator().manual_seed(0),
                      "cpu")
    assert "head" not in p
    x = torch.randn(2, 1, cfg.d_model).to(torch.bfloat16)
    assert torch.equal(TL.logits_from(p, cfg, x), (x @ p["tok"].T).float())
