"""The port's decode steps and token selection against the JAX reference.

* ``decode_paged_chunk`` and ``decode_step`` against the same reference
  function on the same bridged weights and inputs, reduced deepseek-7b:
  within 2 bf16 ulps of the logit scale against the reference's layer
  functions run op by op, within 8 against its compiled step.
  Each bound is set against its own reference function, never across
  paths (the reference's decode and prefill paths themselves drift by
  about 1.5% in bf16).
* Token selection: the exact filtering (temperature, top-k, nucleus) plus
  JAX's own Gumbel noise, injected, gives JAX's tokens exactly.  The port
  draws its noise from its own counter-based hash; that generator's
  properties (pure function of (seed, rid, step), same bits on any
  device) are tested here too.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ALL_ARCHS as T_ARCHS
from repro_torch.configs import reduced as t_reduced
from repro_torch.models import build as t_build
from repro_torch.models import decode as TD
from repro_torch.models import params as TP

ARCH = "deepseek-7b"
# budgets in bf16 ulps of the largest logit (see _close): op by op the
# two frameworks differ only in the order of fp32 sums inside attention;
# the compiled reference also skips a bf16 rounding per sub-block
LAYER_ULPS = 2
COMPILED_ULPS = 8


@pytest.fixture(scope="module")
def served():
    """Reduced deepseek-7b in both frameworks on the same weights."""
    jax = pytest.importorskip("jax")
    from repro.configs import ALL_ARCHS, reduced
    from repro.models import build
    cfg = reduced(ALL_ARCHS[ARCH])
    model = build(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    tmodel = t_build(t_reduced(T_ARCHS[ARCH]))
    return model, params, tmodel, TP.from_jax(jax.tree.map(np.asarray, params))


def _by_layer(cfg, params, x, attend):
    """The reference's layer functions composed op by op, as the port runs
    them: ``attend(i, p_attn, h) -> a`` is layer i's attention.  Returns
    the final hidden states."""
    import jax
    from repro.models.layers import rmsnorm, swiglu
    for i in range(cfg.n_layers):
        p = jax.tree.map(lambda a: a[i], params["layers"])
        x = x + attend(i, p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps))
        x = x + swiglu(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps))
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def _close(got, want, ulps):
    """Port logits against a reference's, within ``ulps`` bf16 ulps of the
    largest reference logit.  Op by op (``LAYER_ULPS``), the only source
    of difference is the order of the fp32 sums in attention, which can
    flip a bf16 rounding of its output.  XLA compiles the reference's
    ``lax.scan`` step as one program and keeps the residual add that feeds
    each RMSNorm in fp32 (``COMPILED_ULPS``).  The argmax must agree
    wherever the reference's top-2 gap exceeds twice the budget."""
    got, want = np.asarray(got), np.asarray(want)
    tol = ulps * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= tol
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    assert (got.argmax(-1) == want.argmax(-1))[clear].all()


def _paged_inputs(cfg):
    """Three ticks over a 16-page pool: prefill chunks, a decode lane, an
    idle lane, ragged chunk ends."""
    rng = np.random.default_rng(0)
    table = np.array([[3, 7, 1, 0], [5, 2, 9, 0], [11, 4, 0, 0]], np.int32)
    for pos, n_new in (([0, 0, 0], [4, 3, 0]), ([4, 3, 0], [1, 4, 2]),
                       ([5, 7, 2], [1, 1, 4])):
        toks = rng.integers(0, cfg.vocab_size, size=(3, 4)).astype(np.int32)
        yield toks, np.asarray(pos, np.int32), np.asarray(n_new, np.int32), table


def _zero_pools(spec, framework):
    import jax.numpy as jnp
    if framework == "jax":
        return {k: jnp.zeros(s.shape, s.dtype) for k, s in spec.items()}
    return {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in spec.items()}


def test_decode_paged_chunk_matches_reference_layers(served):
    """The port's paged step against the reference's layer functions run
    op by op: logits at each lane's last real row, and both pools."""
    import jax.numpy as jnp
    from repro.models.attention import paged_chunk_decode_attention
    from repro.models.layers import embed_tokens, logits_from
    model, params, tmodel, tparams = served
    cfg = model.cfg
    jp = _zero_pools(model.paged_cache_specs(16, 8)["paged"], "jax")
    tp = _zero_pools(tmodel.paged_cache_specs(16, 8)["paged"], "torch")
    for toks, pos, n_new, table in _paged_inputs(cfg):
        args = [jnp.asarray(a) for a in (pos, n_new, table)]

        def attend(i, p, h):
            y, k, v = paged_chunk_decode_attention(
                cfg, p, h, jp["k"][i], jp["v"][i], args[2], args[0], args[1])
            jp["k"], jp["v"] = jp["k"].at[i].set(k), jp["v"].at[i].set(v)
            return y

        x = _by_layer(cfg, params, embed_tokens(params["embed"],
                                                jnp.asarray(toks)), attend)
        x = x[jnp.arange(3), jnp.maximum(args[1], 1) - 1][:, None]
        want = np.asarray(logits_from(params["embed"], cfg, x)[:, 0])
        got = tmodel.decode_paged_chunk(
            tparams, {"paged": tp}, torch.tensor(toks),
            *map(torch.tensor, (pos, n_new, table)))
        assert got.shape == (3, cfg.padded_vocab)
        _close(got.numpy(), want, LAYER_ULPS)
    for k in ("k", "v"):
        np.testing.assert_allclose(tp[k].float().numpy(),
                                   np.asarray(jp[k].astype(jnp.float32)),
                                   rtol=2e-2, atol=2e-2)


def test_decode_paged_chunk_within_compiled_reference(served):
    """Against the reference's compiled step, as its engine runs it."""
    import jax
    import jax.numpy as jnp
    model, params, tmodel, tparams = served
    step = jax.jit(model.decode_paged_chunk)
    jcache = {"paged": _zero_pools(model.paged_cache_specs(16, 8)["paged"],
                                   "jax")}
    tcache = {"paged": _zero_pools(tmodel.paged_cache_specs(16, 8)["paged"],
                                   "torch")}
    for toks, *args in _paged_inputs(model.cfg):
        want, jcache = step(params, jcache, jnp.asarray(toks),
                            *map(jnp.asarray, args))
        got = tmodel.decode_paged_chunk(tparams, tcache, torch.tensor(toks),
                                        *map(torch.tensor, args))
        _close(got.numpy(), want, COMPILED_ULPS)


def _step_inputs(cfg, n=6):
    rng = np.random.default_rng(1)
    for i in range(n):
        tok = rng.integers(0, cfg.vocab_size, size=(2, 1)).astype(np.int32)
        yield tok, np.array([i, i + 3], np.int32)


def test_decode_step_matches_reference_layers(served):
    """The contiguous oracle's step against the reference's layer
    functions run op by op: logits and cache rows."""
    import jax.numpy as jnp
    from repro.models.attention import decode_attention
    from repro.models.layers import embed_tokens, logits_from
    model, params, tmodel, tparams = served
    cfg = model.cfg
    spec = model.cache_specs(2, 16)["self"]
    jc = _zero_pools(spec, "jax")
    tcache = tmodel.zero_cache(2, 16, "cpu")
    assert {k: tuple(v.shape) for k, v in tcache["self"].items()} == {
        k: s.shape for k, s in spec.items()}
    for tok, pos in _step_inputs(cfg):
        def attend(i, p, h):
            y, k, v = decode_attention(cfg, p, h, jc["k"][i], jc["v"][i],
                                       jnp.asarray(pos))
            jc["k"], jc["v"] = jc["k"].at[i].set(k), jc["v"].at[i].set(v)
            return y

        x = _by_layer(cfg, params, embed_tokens(params["embed"],
                                                jnp.asarray(tok)), attend)
        want = np.asarray(logits_from(params["embed"], cfg, x)[:, 0])
        got = tmodel.decode_step(tparams, tcache, torch.tensor(tok),
                                 torch.tensor(pos))
        _close(got.numpy(), want, LAYER_ULPS)
    np.testing.assert_allclose(tcache["self"]["k"].float().numpy(),
                               np.asarray(jc["k"].astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_decode_step_within_compiled_reference(served):
    import jax
    import jax.numpy as jnp
    model, params, tmodel, tparams = served
    step = jax.jit(model.decode_step)
    jcache = {"self": _zero_pools(model.cache_specs(2, 16)["self"], "jax")}
    tcache = tmodel.zero_cache(2, 16, "cpu")
    for tok, pos in _step_inputs(model.cfg):
        want, jcache = step(params, jcache, jnp.asarray(tok),
                            jnp.asarray(pos))
        got = tmodel.decode_step(tparams, tcache, torch.tensor(tok),
                                 torch.tensor(pos))
        _close(got.numpy(), want, COMPILED_ULPS)


def test_cache_specs_match_reference(served):
    model, _, tmodel, _ = served
    for want, got in ((model.cache_specs(3, 40), tmodel.cache_specs(3, 40)),
                      (model.paged_cache_specs(24, 8),
                       tmodel.paged_cache_specs(24, 8))):
        for group in want:
            for k in want[group]:
                assert tuple(got[group][k].shape) == want[group][k].shape
                assert got[group][k].dtype == torch.bfloat16


# ------------------------------------------------------------ token selection


def _lanes(rng, b):
    """Per-lane sampling state with greedy lanes, top-k only, nucleus only,
    both, and the no-cut case, as numpy arrays."""
    temperature = rng.choice([0.0, 0.7, 1.0, 1.3], size=b).astype(np.float32)
    temperature[0] = 0.0
    temperature[1] = 0.8
    return {
        "rid": rng.integers(0, 1000, size=b).astype(np.int32),
        "step": rng.integers(0, 50, size=b).astype(np.int32),
        "seed": rng.integers(0, 2**31 - 1, size=b).astype(np.int32),
        "temperature": temperature,
        "top_k": rng.choice([0, 1, 5, 50], size=b).astype(np.int32),
        "top_p": rng.choice([1.0, 0.9, 0.5, 0.05], size=b).astype(np.float32),
    }


@pytest.mark.parametrize("seed", range(6))
def test_selection_with_injected_noise_matches_reference(seed):
    """The reference's fused selection and the port's, fed the reference's
    own per-lane Gumbel noise, pick the same tokens."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.models.decode import lane_keys, sample_from_logits
    rng = np.random.default_rng(seed)
    b, v = 8, 512
    logits = (rng.standard_normal((b, v)) * rng.uniform(0.5, 4.0)
              ).astype(np.float32)
    lane = _lanes(rng, b)
    jlane = {k: jnp.asarray(a) for k, a in lane.items()}
    want = np.asarray(sample_from_logits(jnp.asarray(logits), jlane))
    keys = lane_keys(jlane["seed"], jlane["rid"], jlane["step"])
    noise = jax.vmap(lambda k: jax.random.gumbel(k, (v,), jnp.float32))(keys)
    got = TD.select_tokens(torch.tensor(logits),
                           {k: torch.tensor(a) for k, a in lane.items()},
                           torch.tensor(np.asarray(noise)))
    assert (got.numpy() == want).all()


def test_filter_keeps_the_reference_candidate_set():
    """Top-k, nucleus and their combination keep exactly the candidates the
    reference's rule names (checked by brute force), and the argmax always
    survives."""
    rng = np.random.default_rng(7)
    b, v = 6, 64
    logits = rng.standard_normal((b, v)).astype(np.float32) * 2
    lane = {k: torch.tensor(a) for k, a in _lanes(rng, b).items()}
    kept = torch.isfinite(TD.filter_logits(torch.tensor(logits), lane)).numpy()
    for i in range(b):
        t = max(float(lane["temperature"][i]), 1e-6)
        scaled = logits[i] / t
        order = np.sort(scaled)[::-1]
        k = int(lane["top_k"][i]) or v
        p = np.exp(order - order.max())
        p /= p.sum()
        excl = np.cumsum(p) - p
        top_p = float(lane["top_p"][i])
        n_keep = v if top_p >= 1 else int((excl < top_p).sum())
        floor = max(order[min(k, v) - 1], order[n_keep - 1])
        assert (kept[i] == (scaled >= floor)).all(), i
        assert kept[i][logits[i].argmax()]


def test_lane_noise_is_a_pure_function_of_its_counters():
    seed = torch.tensor([7, 7, 7, 8], dtype=torch.int32)
    rid = torch.tensor([1, 1, 2, 1], dtype=torch.int32)
    step = torch.tensor([0, 0, 0, 0], dtype=torch.int32)
    a = TD.lane_gumbel(seed, rid, step, 4096)
    b = TD.lane_gumbel(seed, rid, step, 4096)
    assert torch.equal(a, b)                     # no generator state
    assert torch.equal(a[0], a[1])               # same counters, same draw
    assert not torch.equal(a[0], a[2])           # another request
    assert not torch.equal(a[0], a[3])           # another seed
    assert not torch.equal(
        a[0], TD.lane_gumbel(seed, rid, step + 1, 4096)[0])   # next token
    assert torch.isfinite(a).all()
    # a standard Gumbel: mean is the Euler-Mascheroni constant, var pi^2/6
    big = TD.lane_gumbel(seed[:1], rid[:1], step[:1], 1 << 18)
    assert abs(float(big.mean()) - 0.5772) < 0.01
    assert abs(float(big.var()) - np.pi ** 2 / 6) < 0.03


def test_sampled_and_greedy_lanes_in_one_batch():
    """Greedy lanes get the exact argmax whatever the noise; sampled lanes
    with top_k=1 do too."""
    rng = np.random.default_rng(3)
    logits = torch.tensor(rng.standard_normal((4, 100)).astype(np.float32))
    lane = {"rid": torch.arange(4, dtype=torch.int32),
            "step": torch.zeros(4, dtype=torch.int32),
            "seed": torch.full((4,), 5, dtype=torch.int32),
            "temperature": torch.tensor([0.0, 0.0, 1.0, 1.0]),
            "top_k": torch.tensor([0, 0, 1, 0], dtype=torch.int32),
            "top_p": torch.ones(4)}
    out = TD.sample_from_logits(logits, lane)
    assert torch.equal(out[:3], logits.argmax(-1)[:3])
