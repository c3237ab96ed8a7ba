"""The port's ssm (Mamba2) and hybrid (zamba2) families against the JAX
reference, on the CPU, at ``reduced()`` size (4 layers, d_model 128,
8 SSM heads of head dim 32, state 16, chunk 16, vocab 512; zamba2 as two
groups of one Mamba2 block and the shared attention block).

Both sides run the reference's ``Model.init_params`` weights through the
bit-exact bridge and the same numpy inputs.  Tolerances, each with its
reason:

* ``causal_conv``: bit-exact in bf16 (the same ops in the same order, each
  rounded to bf16 in both frameworks);
* ``mamba_block`` (with its final state) and ``mamba_decode``: f32 1e-5
  (sum orders); bf16 outputs within 2 bf16 ulps of their scale, the states
  1e-2 relative (bf16 inputs to fp32 sums in another order);
* ``Model.loss`` and every gradient against ``jax.value_and_grad`` of the
  reference's loss (it trains through the jnp ``ssd_chunked``; its SSD
  kernel has no backward, ROADMAP caveat h): f32 loss and gradients 1e-5
  relative (norm), with the reference's bf16 cotangent pin lifted
  (caveat f); bf16 loss 1e-3 relative and each gradient within 16 bf16
  ulps of its largest entry (caveat d: the compiled reference keeps some
  intermediates in fp32 that the port rounds, which moves every bf16
  gradient by 1-4% in norm and by up to 12 ulps of its largest entry, the
  same in every leaf; the hybrid's shared attention also keeps P in fp32
  on the flash route where the reference's jnp path rounds it);
* ``Model.prefill`` (logits and every cache leaf) and the ``decode_step``
  that continues it, for ssm, hybrid and dense, against the reference's
  compiled ``prefill`` and ``decode_step``: logits within 8 bf16 ulps of
  their scale, argmax equal where the top-2 gap is clear (the near-tie
  rule of ``tests/test_torch_decode.py``); every cache leaf within the
  same budget of its largest entry;
* ``ServeEngine`` at 1 and 3 slots against the reference's engine with
  each step's host inputs copied (caveat a: its serial prefill hands the
  async step host buffers it then mutates), call by call: the same
  inputs, logits within the 8-ulp budget and the same tokens, except
  where the reference's top two logits are a near tie.  At 3 slots the
  reference's engine advances every lane's SSM state once per prompt
  token of every later admission (caveat g); the port keeps that
  behaviour, so the streams are held to the reference's engine, and a
  request alone in a one-slot engine also to prefill + decode_step;
* three f32 training steps of reduced mamba2 against the reference's
  jitted step: losses 1e-5, parameters 1e-4 relative norm.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import ALL_ARCHS as T_ARCHS
from repro_torch.configs import reduced as t_reduced
from repro_torch.configs.base import RunConfig, ShapeConfig, TrainConfig
from repro_torch.models import build as t_build
from repro_torch.models import params as TP
from repro_torch.models import ssm as TS
from repro_torch.serve import Request, ServeEngine
from repro_torch.train.step import make_train_step, train_state_from_jax

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

FAMILIES = {"ssm": "mamba2-2.7b", "hybrid": "zamba2-2.7b",
            "dense": "deepseek-7b"}
SEQ, BATCH = 64, 2
COMPILED_ULPS = 8
GRAD_ULPS = 16


def _cfgs(arch):
    from repro.configs import ALL_ARCHS, reduced
    return reduced(ALL_ARCHS[arch]), t_reduced(T_ARCHS[arch])


@functools.lru_cache(maxsize=None)
def _params(arch, dtype="bfloat16"):
    """The reference's initial weights as numpy: as initialised (bf16
    matrices and norms, fp32 ``a_log``, ``d_skip``, ``dt_bias``) for
    "bfloat16", every leaf cast for "float32"."""
    from repro.models import build
    cfg, _ = _cfgs(arch)
    params = build(cfg).init_params(jax.random.PRNGKey(0))
    if dtype != "bfloat16":
        params = jax.tree.map(lambda a: a.astype(getattr(jnp, dtype)),
                              params)
    return jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference model of ``arch`` with its compiled prefill and decode
    step, shared by the tests (compiled once per shape)."""
    from repro.models import build
    model = build(_cfgs(arch)[0])
    return (model, jax.jit(model.prefill, static_argnums=2),
            jax.jit(model.decode_step))


def _layer0(arch, dtype):
    p = _params(arch, dtype)["layers"]["mamba"]
    return (jax.tree.map(lambda a: jnp.asarray(a[0]), p),
            TP.tree_map(lambda t: t[0], TP.from_jax(p)))


def _tokens(seed, batch=BATCH, seq=SEQ, vocab=512):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(batch, seq + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _rel(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _ulp_close(got, want, ulps):
    """Within ``ulps`` bf16 ulps of the largest reference value."""
    got, want = _np(got), _np(want)
    tol = ulps * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)
    return tol


def _logits_close(got, want, ulps=COMPILED_ULPS):
    """Logits within the ulp budget; argmax equal wherever the reference's
    top-2 gap exceeds twice it (the near-tie rule)."""
    tol = _ulp_close(got, want, ulps)
    want = _np(want)
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    assert (_np(got).argmax(-1) == want.argmax(-1))[clear].all()


# ------------------------------------------------------------------ specs


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_param_specs_match_reference(arch):
    """The ssm and hybrid spec trees have the reference's keys, shapes,
    axes, dtypes and initializers at full width, and its counts."""
    from repro.configs import ALL_ARCHS
    from repro.models import stack

    def flat(tree, path=()):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items()
                    for k, v in flat(sub, path + (key,)).items()}
        dtype = (str(tree.dtype).replace("torch.", "")
                 if isinstance(tree.dtype, torch.dtype)
                 else jnp.dtype(tree.dtype).name)
        return {path: (tuple(tree.shape), tuple(tree.axes), dtype, tree.init)}

    assert flat(TP.param_specs(T_ARCHS[arch])) == flat(
        stack.param_specs(ALL_ARCHS[arch]))
    assert T_ARCHS[arch].param_count() == stack.param_count(ALL_ARCHS[arch])


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_weight_bridge_carries_the_trees_bit_for_bit(arch):
    """The reference's initial ssm and hybrid weights (bf16 matrices, fp32
    a_log, d_skip and dt_bias) cross the bridge unchanged: keys, shapes,
    dtypes and bits."""
    raw = _params(arch)
    tparams = TP.from_jax(raw)
    flat = jax.tree_util.tree_flatten_with_path(raw)[0]
    assert len(flat) == len(TP.leaves(tparams))
    for path, leaf in flat:
        t = tparams
        for k in path:
            t = t[k.key]
        assert str(t.dtype).replace("torch.", "") == leaf.dtype.name, path
        view = (np.int16, torch.int16) if leaf.dtype.itemsize == 2 else (
            np.int32, torch.int32)
        np.testing.assert_array_equal(t.view(view[1]).numpy(),
                                      np.array(leaf).view(view[0]),
                                      err_msg=str(path))


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_cache_specs_match_reference(arch):
    """The contiguous engine's caches: same keys, shapes and dtypes."""
    from repro.models import build
    cfg_r, cfg_t = _cfgs(arch)
    want = jax.tree.map(lambda s: (tuple(s.shape), jnp.dtype(s.dtype).name),
                        build(cfg_r).cache_specs(3, 40))
    got = TP.tree_map(lambda s: (tuple(s.shape),
                                 str(s.dtype).replace("torch.", "")),
                      t_build(cfg_t).cache_specs(3, 40))
    assert got == want


# ---------------------------------------------------------------- the block


def test_causal_conv_is_bit_exact():
    from repro.models.ssm import causal_conv
    p_r, p_t = _layer0("mamba2-2.7b", "bfloat16")
    x = np.random.default_rng(1).standard_normal((2, 20, p_t["conv_w"].shape[1]))
    want = causal_conv(p_r["conv_w"], p_r["conv_b"],
                       jnp.asarray(x, jnp.bfloat16))
    got = TS.causal_conv(p_t["conv_w"], p_t["conv_b"],
                         torch.tensor(x, dtype=torch.bfloat16))
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_with_state_matches_reference(dtype):
    from repro.models.ssm import mamba_block
    cfg_r, cfg_t = _cfgs("mamba2-2.7b")
    p_r, p_t = _layer0("mamba2-2.7b", dtype)
    x = np.random.default_rng(2).standard_normal((2, 48, cfg_t.d_model))
    want, (conv_r, ssm_r) = jax.jit(functools.partial(
        mamba_block, cfg_r, return_state=True))(
        p_r, jnp.asarray(x, getattr(jnp, dtype)))
    got, (conv_t, ssm_t) = TS.mamba_block(
        cfg_t, p_t, torch.tensor(x, dtype=getattr(torch, dtype)),
        return_state=True)
    assert got.dtype == getattr(torch, dtype) and ssm_t.dtype == torch.float32
    if dtype == "float32":
        for a, b in ((got, want), (conv_t, conv_r), (ssm_t, ssm_r)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5)
    else:
        _ulp_close(got, want, 2)
        _ulp_close(conv_t, conv_r, 2)
        assert _rel(ssm_t, ssm_r) <= 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_matches_reference(dtype):
    """Four tokens stepped through ``mamba_decode`` from a prefilled state:
    outputs and both states after each step (the port's in place)."""
    from repro.models.ssm import mamba_block, mamba_decode
    cfg_r, cfg_t = _cfgs("mamba2-2.7b")
    p_r, p_t = _layer0("mamba2-2.7b", dtype)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    x = np.random.default_rng(3).standard_normal((2, 36, cfg_t.d_model))
    _, (conv_r, ssm_r) = jax.jit(functools.partial(
        mamba_block, cfg_r, return_state=True))(p_r,
                                                jnp.asarray(x[:, :32], jd))
    conv_t, ssm_t = TP.from_jax({"c": conv_r, "s": ssm_r}).values()
    step = jax.jit(functools.partial(mamba_decode, cfg_r))
    for i in range(32, 36):
        want, conv_r, ssm_r = step(p_r, jnp.asarray(x[:, i:i + 1], jd),
                                   conv_r, ssm_r)
        got = TS.mamba_decode(cfg_t, p_t, torch.tensor(x[:, i:i + 1],
                                                       dtype=td),
                              conv_t, ssm_t)
        if dtype == "float32":
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(_np(ssm_t), _np(ssm_r), rtol=1e-5,
                                       atol=1e-5)
        else:
            _ulp_close(got, want, 2)
            assert _rel(ssm_t, ssm_r) <= 1e-2
        np.testing.assert_allclose(_np(conv_t), _np(conv_r), rtol=1e-5,
                                   atol=1e-5)


# -------------------------------------------------------------- training


def _f32_cotangents(monkeypatch):
    """The reference's residual boundary pins every cotangent to bf16,
    which JAX refuses for an f32 primal (caveat f): the pin becomes the
    identity inside this test only."""
    import repro.models.stack as r_stack
    monkeypatch.setattr(r_stack, "_bf16_tangent", lambda x: x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_loss_and_gradients_match_jax_value_and_grad(arch, remat, dtype,
                                                     monkeypatch):
    from repro.models import build
    if dtype == "float32":
        _f32_cotangents(monkeypatch)
    cfg_r, cfg_t = _cfgs(arch)
    params = _params(arch, dtype)
    batch = _tokens(seed=4)
    (want, _), want_g = jax.jit(jax.value_and_grad(
        lambda p, b: build(cfg_r).loss(p, b, remat=remat, z_loss=1e-4),
        has_aux=True))(params, batch)
    live = TP.tree_map(lambda t: t.requires_grad_(), TP.from_jax(params))
    got, _ = t_build(cfg_t).loss(
        live, {k: torch.tensor(v) for k, v in batch.items()}, remat=remat,
        z_loss=1e-4)
    got.backward()
    loss_tol = 1e-5 if dtype == "float32" else 1e-3
    assert abs(got.item() - float(want)) <= loss_tol * abs(float(want))
    got_g = TP.leaves(TP.tree_map(lambda t: t.grad, live))
    want_leaves = jax.tree.leaves(want_g)
    assert len(got_g) == len(want_leaves)
    for g, w in zip(got_g, want_leaves):
        assert str(g.dtype).replace("torch.", "") == w.dtype.name
        if dtype == "float32":
            assert _rel(g, w) <= 1e-5, (g.shape, _rel(g, w))
        else:
            _ulp_close(g, w, GRAD_ULPS)


def test_loss_matches_the_reference_kernel_path():
    """The port's loss (the plain SSD on the CPU) against the reference's
    ``Model(use_pallas=True).loss``, its SSD kernel in interpret mode, in
    f32 (2e-6 relative)."""
    from repro.models import build
    cfg_r, cfg_t = _cfgs("mamba2-2.7b")
    params = _params("mamba2-2.7b", "float32")
    batch = _tokens(seed=5)
    want, _ = build(cfg_r, use_pallas=True).loss(params, batch)
    got, _ = t_build(cfg_t).loss(TP.from_jax(params),
                                 {k: torch.tensor(v) for k, v in
                                  batch.items()})
    assert abs(float(got) - float(want)) <= 2e-6 * abs(float(want))


def test_train_steps_track_reference(monkeypatch):
    """Three steps through ``make_train_step`` against the reference's
    jitted step, f32 parameters, remat full, reduced mamba2."""
    _f32_cotangents(monkeypatch)
    from repro.configs.base import RunConfig as RRun
    from repro.configs.base import ShapeConfig as RShape
    from repro.configs.base import TrainConfig as RTrain
    from repro.models import build
    from repro.optim import adamw as r_adamw
    from repro.train.step import TrainState as RState
    from repro.train.step import make_train_step as r_make
    cfg_r, cfg_t = _cfgs("mamba2-2.7b")
    tc = dict(warmup_steps=1, total_steps=3)
    r_step = jax.jit(r_make(build(cfg_r), RRun(
        cfg_r, RShape("t", "train", SEQ, BATCH), train=RTrain(**tc))))
    t_step = make_train_step(t_build(cfg_t), RunConfig(
        cfg_t, ShapeConfig("t", "train", SEQ, BATCH), TrainConfig(**tc)))
    params = _params("mamba2-2.7b", "float32")
    r_state = jax.tree.map(np.asarray, RState(params, r_adamw.init(params)))
    t_state = train_state_from_jax(r_state)
    for i in range(3):
        batch = _tokens(seed=10 + i)
        r_state, r_m = r_step(r_state, batch)
        t_state, t_m = t_step(t_state, {k: torch.tensor(v)
                                        for k, v in batch.items()})
        assert abs(float(t_m["loss"]) - float(r_m["loss"])) <= 1e-5 * abs(
            float(r_m["loss"])), i
    for a, b in zip(TP.leaves(t_state.params),
                    jax.tree.leaves(r_state.params)):
        assert _rel(a, b) <= 1e-4, (a.shape, _rel(a, b))


# ------------------------------------------------------- prefill, decode


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_prefill_and_decode_step_match_reference(family):
    """``Model.prefill`` (logits and every cache leaf, decode headroom
    included) against the reference's compiled prefill, then three
    ``decode_step`` calls continuing it against its compiled step."""
    arch = FAMILIES[family]
    _, cfg_t = _cfgs(arch)
    _, prefill, step = _reference(arch)
    params = _params(arch)
    tparams = TP.from_jax(params)
    tmodel = t_build(cfg_t)
    toks = _tokens(seed=6, seq=32)["tokens"]
    want, jcache = prefill(params, {"tokens": toks}, 40)
    got, tcache = tmodel.prefill(tparams, {"tokens": torch.tensor(toks)}, 40)
    _logits_close(got, want)
    want_leaves = jax.tree_util.tree_flatten_with_path(jcache)[0]
    assert len(want_leaves) == len(TP.leaves(tcache))
    for path, leaf in want_leaves:
        t = tcache
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).replace("torch.", "") == leaf.dtype.name, path
        _ulp_close(t, leaf, COMPILED_ULPS)
    rng = np.random.default_rng(7)
    for i in range(3):
        tok = rng.integers(0, cfg_t.vocab_size, size=(BATCH, 1)).astype(
            np.int32)
        pos = np.full((BATCH,), 32 + i, np.int32)
        want, jcache = step(params, jcache, jnp.asarray(tok),
                            jnp.asarray(pos))
        got = tmodel.decode_step(tparams, tcache, torch.tensor(tok),
                                 torch.tensor(pos))
        _logits_close(got, want)


# ---------------------------------------------------------------- engine


def _prompts(n=3, length=12):
    rng = np.random.default_rng(8)
    return [rng.integers(0, 512, size=length).tolist() for _ in range(n)]


def _reference_run(arch, prompts, slots, max_new=6):
    """The reference's contiguous engine on ``prompts``: its streams and,
    per decode call, (tokens in, positions, logits).  Each call's host
    inputs are copied before the step sees them, so the mutation of the
    engine's host buffers after dispatch cannot reach it (caveat a);
    test-side only."""
    from repro.serve.engine import Request as RRequest
    from repro.serve.engine import ServeEngine as RServe
    model, _, step = _reference(arch)
    eng = RServe(model, _params(arch), slots=slots, max_len=64)
    calls = []

    def greedy(params, cache, tok, pos):
        tok, pos = np.array(tok), np.array(pos)
        logits, cache = step(params, cache, jnp.asarray(tok),
                             jnp.asarray(pos))
        calls.append((tok[:, 0], pos, np.asarray(logits)))
        return jnp.argmax(logits, axis=-1), cache

    eng._decode = greedy
    done = eng.run([RRequest(rid=i, prompt=p, max_new=max_new)
                    for i, p in enumerate(prompts)])
    return {r.rid: r.out for r in done}, calls


class _Recording:
    """The port's model with each greedy decode call's (tokens in,
    positions, logits) kept."""

    def __init__(self, model):
        self.model, self.cfg, self.calls = model, model.cfg, []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def decode_greedy_step(self, params, cache, token, pos):
        logits = self.model.decode_step(params, cache, token, pos)
        self.calls.append((token[:, 0].numpy().copy(), pos.numpy().copy(),
                           logits.numpy().copy()))
        return logits.argmax(dim=-1)


def _port_run(arch, prompts, slots, max_new=6):
    _, cfg_t = _cfgs(arch)
    model = _Recording(t_build(cfg_t))
    eng = ServeEngine(model, TP.from_jax(_params(arch)), slots=slots,
                      max_len=64, device="cpu")
    done = eng.run([Request(rid=i, prompt=p, max_new=max_new)
                    for i, p in enumerate(prompts)])
    assert eng.report()["served"] == len(prompts)
    return {r.rid: r.out for r in done}, model.calls


@pytest.mark.parametrize("slots", [1, 3])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_engine_streams_match_reference_engine(arch, slots):
    """Call by call, each lane whose input token still agrees gets logits
    within the ulp budget and the same argmax, unless the reference's top
    two logits are a near tie.  A lane's input may part from the
    reference's only after such a tie on that lane; it is followed no
    further from there."""
    prompts = _prompts()
    got, got_calls = _port_run(arch, prompts, slots)
    want, want_calls = _reference_run(arch, prompts, slots)
    assert len(got_calls) == len(want_calls)
    followed, tied = np.ones(slots, bool), np.zeros(slots, bool)
    for (t_tok, t_pos, t_log), (r_tok, r_pos, r_log) in zip(got_calls,
                                                            want_calls):
        np.testing.assert_array_equal(t_pos, r_pos)
        for lane in np.flatnonzero(followed):
            if t_tok[lane] != r_tok[lane]:
                assert tied[lane], lane
                followed[lane] = False
                continue
            tol = _ulp_close(t_log[lane:lane + 1], r_log[lane:lane + 1],
                             COMPILED_ULPS)
            if t_log[lane].argmax() != r_log[lane].argmax():
                top2 = np.sort(r_log[lane])[-2:]
                assert top2[1] - top2[0] <= 2 * tol, (lane, top2)
                tied[lane] = True
    if not tied.any():
        assert got == want


def test_single_slot_streams_are_prefill_then_decode():
    """mamba2: a request alone in a fresh one-slot engine gets its prompt's
    ``prefill`` followed by greedy ``decode_step``s (the reference's,
    compiled): both run the same recurrence.  (The hybrid's prefill and
    decode attention round differently, caveat b, so its streams are held
    to the reference's engine only.)  A slot keeps its state from one
    request to the next and, with more slots, every admission steps every
    lane (caveat g, in both packages), so the first of three requests
    admitted together moves off its own stream."""
    arch = "mamba2-2.7b"
    _, prefill, step = _reference(arch)
    params = _params(arch)
    prompts = _prompts()
    for rid, prompt in enumerate(prompts):
        logits, cache = prefill(params, {"tokens": np.asarray([prompt],
                                                               np.int32)}, 64)
        want = [int(jnp.argmax(logits[0]))]
        for i in range(5):
            logits, cache = step(params, cache,
                                 jnp.asarray([[want[-1]]], jnp.int32),
                                 jnp.asarray([len(prompt) + i], jnp.int32))
            want.append(int(jnp.argmax(logits[0])))
        got, _ = _port_run(arch, [prompt], 1)
        assert got[0] == want, rid
        if rid == 0:
            crowded, _ = _port_run(arch, prompts, 3)
            assert crowded[0] != want


# ------------------------------------------------------------ entry points


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_serve_cli_serves_stateful_families_contiguously(arch, capsys):
    """Asked for the paged engine, the CLI serves the ssm and hybrid archs
    through the contiguous one, and its report says so."""
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--arch", arch, "--requests", "3",
          "--max-new", "4"])
    res = json.loads(capsys.readouterr().out)
    assert res["engine"] == "contiguous" and res["served"] == 3
    assert "kernel" not in res


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_train_cli_trains_stateful_families(arch, tmp_path):
    """The training launcher takes the ssm and hybrid archs on the CPU and
    reports the reference's result keys."""
    from repro_torch.launch.train import train
    res = train(arch, steps=2, seq_len=32, global_batch=2, device="cpu",
                out_dir=str(tmp_path))
    assert res["arch"] == arch + "-smoke" and len(res["losses"]) == 2
    assert all(np.isfinite(res["losses"]))
    assert set(res) >= {"arch", "steps", "first_loss", "last_loss",
                        "loss_decreased", "wall_s", "fleet_efficiency",
                        "diagnostics", "audit", "image_hash", "wireup"}


def test_sample_batch_takes_its_device_from_the_caller():
    model = t_build(t_reduced(T_ARCHS["mamba2-2.7b"]))
    shape = ShapeConfig("t", "train", 16, 2)
    with pytest.raises(TypeError):
        model.sample_batch(shape, 0)                     # no default device
    batch = model.sample_batch(shape, 0, "cpu")
    assert set(batch) == {"tokens", "labels"}
    assert batch["tokens"].shape == (2, 16) and batch["tokens"].device.type \
        == "cpu"
    for arch in ("mamba2-2.7b", "zamba2-2.7b", "deepseek-7b"):
        assert set(t_build(t_reduced(T_ARCHS[arch])).input_specs(shape)) == {
            "tokens", "labels"}
    with pytest.raises(ValueError, match="dense, moe, ssm and hybrid"):
        t_build(dataclasses.replace(t_reduced(T_ARCHS["whisper-medium"]))
                ).input_specs(shape)
