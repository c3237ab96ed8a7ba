"""The port's MoE family against the JAX reference, on the CPU, at
``reduced()`` size: granite-moe-1b-a400m and qwen3-moe-30b-a3b cut to 4
layers, d_model 128, 4 q heads over 2 kv heads of head dim 32, 8 experts
of d_ff 256, top-2, vocab 512 (qwen3 adds its q/k norms).

Both sides run the reference's ``Model.init_params`` weights through the
bit-exact bridge and the same numpy inputs.  Tolerances, each with its
reason:

* ``moe_local`` against ``_moe_local`` (tp=1) at capacity factors 0.05,
  1.25 and 8.0 and at one row: f32 2e-5 (the expert products' sum
  orders), bf16 2e-2 (in practice bit-equal: the same roundings in the
  same order); the aux equal to 1e-6 relative;
* its gradients for x, the router and the three expert leaves against
  ``jax.grad`` in f32: 1e-5 relative norm;
* ``Model.loss`` and every gradient against ``jax.value_and_grad`` of
  the reference's loss, f32, with its bf16 cotangent pin lifted (ROADMAP
  caveat f): 1e-5 relative (norm);
* ``prefill``, ``decode_step``, ``decode_chunk`` and
  ``decode_paged_chunk`` against the reference's compiled functions, f32
  weights and caches, one step holding a decoding lane whose dead rows
  cross a page edge, a prefill tail and an idle lane: logits within
  ``LOGIT_TOL`` (1e-4 of a logit scale near 3: fp32 sum orders, with no
  top-k choice flipped); every row of ``chunk_decode_attention``, the
  dead ones included, within 2e-5;
* a lane's dead-row tokens swapped: another lane's live logits move by
  more than 1e-3 in the reference, and the port's logits follow within
  ``LOGIT_TOL`` (a moe step routes every row of the batch together);
* greedy f32 streams of ``PagedServeEngine`` on both pathways, and (in
  ``compare_engines``, granite) of the contiguous ``ServeEngine``, token
  for token against the reference's engines (its contiguous engine with
  each step's host inputs copied, caveat a); ``compare_engines`` gives
  the verdict the reference's own streams give;
* both CLIs at ``--device cpu``; a resumed training run reproduces the
  uninterrupted run's losses exactly.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import ALL_ARCHS as T_ARCHS
from repro_torch.configs import reduced as t_reduced
from repro_torch.models import build as t_build
from repro_torch.models import params as TP
from repro_torch.models.attention import chunk_decode_attention
from repro_torch.models.moe import moe_local
from repro_torch.serve import (PagedServeEngine, Request, compare_engines,
                               token_matrix)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

ARCHS = ["granite-moe-1b-a400m", "qwen3-moe-30b-a3b"]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LOGIT_TOL = 1e-4
GEOM = dict(slots=2, max_len=64, block_size=8, chunk=4)


def _cfgs(arch, **kw):
    from repro.configs import ALL_ARCHS, reduced
    return (dataclasses.replace(reduced(ALL_ARCHS[arch]), **kw),
            dataclasses.replace(t_reduced(T_ARCHS[arch]), **kw))


@functools.lru_cache(maxsize=None)
def _params(arch, dtype="float32"):
    """The reference's initial weights as numpy, every leaf but the fp32
    router cast to ``dtype``."""
    from repro.models import build
    params = build(_cfgs(arch)[0]).init_params(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a if path[-1].key == "router"
        else a.astype(getattr(jnp, dtype)), params)
    return jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference model of ``arch`` and its compiled decode functions."""
    from repro.models import build
    model = build(_cfgs(arch)[0])
    return model, {"prefill": jax.jit(model.prefill, static_argnums=2),
                   "decode_step": jax.jit(model.decode_step),
                   "decode_chunk": jax.jit(model.decode_chunk),
                   "decode_paged_chunk": jax.jit(model.decode_paged_chunk)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _f32_cotangents(monkeypatch):
    """The reference's residual boundary pins every cotangent to bf16,
    which JAX refuses for an f32 primal (caveat f): the pin becomes the
    identity inside the test only."""
    import repro.models.stack as r_stack
    monkeypatch.setattr(r_stack, "_bf16_tangent", lambda x: x)


def _moe_layer(arch, dtype, cf):
    """Layer 0's moe weights in both frameworks, at capacity factor cf."""
    cfg_r, cfg_t = _cfgs(arch, capacity_factor=cf)
    p = jax.tree.map(lambda a: a[0], _params(arch, dtype)["layers"]["moe"])
    return cfg_r, cfg_t, jax.tree.map(jnp.asarray, p), TP.from_jax(p)


# ---------------------------------------------------------------- moe_local


@pytest.mark.parametrize("shape", [(2, 16), (1, 1)], ids=["2x16", "1x1"])
@pytest.mark.parametrize("cf", [0.05, 1.25, 8.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_local_matches_reference(arch, dtype, cf, shape):
    from repro.models.moe import _moe_local
    cfg_r, cfg_t, p_r, p_t = _moe_layer(arch, dtype, cf)
    x = np.random.default_rng(1).standard_normal(
        shape + (cfg_r.d_model,)).astype(np.float32)
    x_r = jnp.asarray(x, getattr(jnp, dtype))
    y_r, aux_r = _moe_local(cfg_r, p_r, x_r, None, 1)
    y_t, aux_t = moe_local(cfg_t, p_t, TP.from_jax({"x": np.asarray(x_r)})["x"])
    assert y_t.dtype == getattr(torch, dtype) and y_t.shape == x.shape
    np.testing.assert_allclose(_np(y_t), _np(y_r), rtol=TOL[dtype],
                               atol=TOL[dtype])
    assert aux_t.shape == shape
    np.testing.assert_allclose(_np(aux_t), _np(aux_r), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_gradients_match_jax_grad(arch):
    """d/d(x, router, gate, up, down) of ``sum(y * w) + aux`` in f32: the
    router's gradient flows through ``top_w`` and through the aux."""
    from repro.models.moe import _moe_local
    cfg_r, cfg_t, p_r, p_t = _moe_layer(arch, "float32", 1.25)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, cfg_r.d_model)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)

    def f_r(p, x):
        y, aux = _moe_local(cfg_r, p, x, None, 1)
        return jnp.sum(y * w) + jnp.mean(aux)

    g_p, g_x = jax.grad(f_r, argnums=(0, 1))(p_r, jnp.asarray(x))
    live = TP.tree_map(lambda t: t.clone().requires_grad_(), p_t)
    x_t = torch.tensor(x, requires_grad=True)
    y, aux = moe_local(cfg_t, live, x_t)
    ((y * torch.tensor(w)).sum() + aux.mean()).backward()
    assert _rel(x_t.grad, g_x) <= 1e-5
    for name in ("router", "gate", "up", "down"):
        assert _rel(live[name].grad, g_p[name]) <= 1e-5, name


# ------------------------------------------------------------------- loss


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax_value_and_grad(arch, remat,
                                                     monkeypatch):
    """The loss with its router aux term, ``moe_aux`` and every gradient,
    f32 (caveat f's pin lifted)."""
    from repro.models import build
    _f32_cotangents(monkeypatch)
    cfg_r, cfg_t = _cfgs(arch)
    params = _params(arch)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 512, size=(2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p, b: build(cfg_r).loss(p, b, remat=remat, z_loss=1e-4),
        has_aux=True))(params, batch)
    live = TP.tree_map(lambda t: t.requires_grad_(), TP.from_jax(params))
    got, got_m = t_build(cfg_t).loss(
        live, {k: torch.tensor(v) for k, v in batch.items()}, remat=remat,
        z_loss=1e-4)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    assert abs(got_m["moe_aux"].item() - float(want_m["moe_aux"])) <= 1e-6
    got_g = TP.leaves(TP.tree_map(lambda t: t.grad, live))
    want_leaves = jax.tree.leaves(want_g)
    assert len(got_g) == len(want_leaves)
    for g, w in zip(got_g, want_leaves):
        assert _rel(g, w) <= 1e-5, (g.shape, _rel(g, w))


# ----------------------------------------------------------------- decode


def _zeros(spec, framework):
    """A cache tree of zeros in f32, in either framework."""
    if isinstance(spec, dict):
        return {k: _zeros(v, framework) for k, v in spec.items()}
    if framework == "jax":
        return jnp.zeros(spec.shape, jnp.float32)
    return torch.zeros(spec.shape, dtype=torch.float32)


# (pos, n_new) of three lanes, chunk 4, pages of 8: two prefills, then a
# decoding lane whose dead rows 7-9 cross into its second page, a prefill
# tail of 2 and an idle lane in one step
CHUNK_STEPS = [([0, 0, 0], [4, 4, 0]), ([4, 4, 0], [2, 4, 0]),
               ([6, 8, 0], [1, 2, 0])]
TABLE = np.array([[3, 7, 1, 0], [5, 2, 9, 0], [11, 4, 0, 0]], np.int32)


def _chunk_tokens(seed, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(3, 4)).astype(np.int32)
            for _ in CHUNK_STEPS]


def _run_chunks(arch, fn, toks_by_step):
    """``decode_chunk`` or ``decode_paged_chunk`` over CHUNK_STEPS in both
    frameworks from zero f32 caches: [(reference logits, port logits)] and
    the final caches."""
    model, jitted = _reference(arch)
    tmodel = t_build(_cfgs(arch)[1])
    if fn == "decode_paged_chunk":
        spec = model.paged_cache_specs(16, 8)
        extra = (TABLE,)
    else:
        spec = model.cache_specs(3, 32)
        extra = ()
    jc, tc = _zeros(spec, "jax"), _zeros(spec, "torch")
    params, tparams = _params(arch), TP.from_jax(_params(arch))
    out = []
    for toks, (pos, n_new) in zip(toks_by_step, CHUNK_STEPS):
        args = (toks, np.asarray(pos, np.int32), np.asarray(n_new, np.int32))
        args += extra
        want, jc = jitted[fn](params, jc, *map(jnp.asarray, args))
        got = getattr(tmodel, fn)(tparams, tc, *map(torch.tensor, args))
        out.append((np.asarray(want), got.numpy()))
    return out, jc, tc


@pytest.mark.parametrize("fn", ["decode_chunk", "decode_paged_chunk"])
@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_steps_match_compiled_reference(arch, fn):
    """Every lane's logits, each step, and every cache row written."""
    out, jc, tc = _run_chunks(arch, fn, _chunk_tokens(5))
    for want, got in out:
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jc)[0]:
        t = tc
        for k in path:
            t = t[k.key]
        np.testing.assert_allclose(_np(t), np.asarray(leaf), rtol=0,
                                   atol=2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_dead_rows_move_other_lanes_as_in_the_reference(arch):
    """Lane 0 of the last step decodes one token; its three dead rows are
    routed with everyone's.  Swapping their tokens moves lane 1's live
    logits in the reference, and the port's follow, on both pathways;
    lane 0's own row, sorted before them, keeps its experts."""
    base = _chunk_tokens(5)
    swapped = [t.copy() for t in base]
    swapped[-1][0, 1:] = (swapped[-1][0, 1:] + 101) % 512
    for fn in ("decode_chunk", "decode_paged_chunk"):
        (want_a, got_a), = _run_chunks(arch, fn, base)[0][-1:]
        (want_b, got_b), = _run_chunks(arch, fn, swapped)[0][-1:]
        assert np.abs(want_b[1] - want_a[1]).max() > 1e-3, fn
        np.testing.assert_allclose(got_a, want_a, rtol=0, atol=LOGIT_TOL)
        np.testing.assert_allclose(got_b, want_b, rtol=0, atol=LOGIT_TOL)
        # earlier rows win the slots: lane 0's live row keeps its experts
        np.testing.assert_array_equal(want_a[0], want_b[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_attention_rows_match_reference_on_every_row(arch):
    """The gather pathway's ``chunk_decode_attention``: all (b, c) rows,
    past ``n_new`` included, equal the reference's (f32)."""
    from repro.models.attention import chunk_decode_attention as r_chunk
    cfg_r, cfg_t = _cfgs(arch)
    p = jax.tree.map(lambda a: a[0], _params(arch)["layers"]["attn"])
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 4, cfg_r.d_model)).astype(np.float32)
    kc = rng.standard_normal((3, 32, 2, 32)).astype(np.float32)
    vc = rng.standard_normal((3, 32, 2, 32)).astype(np.float32)
    pos, n_new = np.array([6, 8, 0], np.int32), np.array([1, 2, 0], np.int32)
    want, _, _ = r_chunk(cfg_r, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                         jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos),
                         jnp.asarray(n_new))
    got = chunk_decode_attention(cfg_t, TP.from_jax(p), torch.tensor(x),
                                 torch.tensor(kc), torch.tensor(vc),
                                 torch.tensor(pos), torch.tensor(n_new))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_step_match_compiled_reference(arch):
    """``prefill`` (logits and both cache leaves, with decode headroom),
    then three ``decode_step`` calls continuing it."""
    _, jitted = _reference(arch)
    params, tparams = _params(arch), TP.from_jax(_params(arch))
    tmodel = t_build(_cfgs(arch)[1])
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 512, size=(2, 12)).astype(np.int32)
    want, jc = jitted["prefill"](params, {"tokens": toks}, 16)
    got, tc = tmodel.prefill(tparams, {"tokens": torch.tensor(toks)}, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(tc["self"][k]),
                                   np.asarray(jc["self"][k]), rtol=0,
                                   atol=2e-5)
    for i in range(3):
        tok = rng.integers(0, 512, size=(2, 1)).astype(np.int32)
        pos = np.full((2,), 12 + i, np.int32)
        want, jc = jitted["decode_step"](params, jc, jnp.asarray(tok),
                                         jnp.asarray(pos))
        got = tmodel.decode_step(tparams, tc, torch.tensor(tok),
                                 torch.tensor(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=LOGIT_TOL)


# ---------------------------------------------------------------- engines


def _workload(vocab=512):
    """``tests/test_integration.py:128``'s trace: a 16-token shared
    prefix, four tails of 3-6 tokens, 6 new tokens each."""
    rng = np.random.default_rng(11)
    shared = rng.integers(0, vocab, size=16).tolist()
    tails = [rng.integers(0, vocab, size=3 + i).tolist() for i in range(4)]
    return [(shared + tails[i], 6) for i in range(4)]


def _requests(cls=Request):
    return [cls(rid=i, prompt=list(p), max_new=n)
            for i, (p, n) in enumerate(_workload())]


@functools.lru_cache(maxsize=None)
def _reference_streams(arch, engine):
    """The reference's greedy f32 streams on the workload: its paged engine
    on either pathway, or its contiguous engine with each step's host
    inputs copied before the step sees them (caveat a; test-side only)."""
    from repro.serve.engine import PagedServeEngine as RPaged
    from repro.serve.engine import Request as RRequest
    from repro.serve.engine import ServeEngine as RServe
    model, jitted = _reference(arch)
    if engine == "contiguous":
        eng = RServe(model, _params(arch), slots=GEOM["slots"],
                     max_len=GEOM["max_len"])

        def greedy(params, cache, tok, pos):
            logits, cache = jitted["decode_step"](
                params, cache, jnp.asarray(np.array(tok)),
                jnp.asarray(np.array(pos)))
            return jnp.argmax(logits, axis=-1), cache

        eng._decode = greedy
    else:
        eng = RPaged(model, _params(arch), kernel=engine, **GEOM)
    return token_matrix(eng.run(_requests(RRequest)), 4, 6)


@pytest.mark.parametrize("kernel", ["paged", "gather"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_streams_match_reference_engines(arch, kernel):
    tmodel = t_build(_cfgs(arch)[1])
    eng = PagedServeEngine(tmodel, TP.from_jax(_params(arch)), kernel=kernel,
                           device="cpu", **GEOM)
    got = token_matrix(eng.run(_requests()), 4, 6)
    assert (got >= 0).all() and (got < 512).all()
    np.testing.assert_array_equal(got, _reference_streams(arch, kernel))


def test_compare_engines_gives_the_reference_verdict():
    """The contiguous ``ServeEngine``'s streams equal the reference's
    contiguous engine's, and the paged engine's its paged engine's.  On
    moe the contiguous oracle routes other rows together than a chunk step
    does, so its streams may part from the paged engine's: the port's
    verdict is the one the reference's own streams give."""
    arch = ARCHS[0]
    tmodel = t_build(_cfgs(arch)[1])
    report = compare_engines(tmodel, TP.from_jax(_params(arch)), _requests,
                             device="cpu", **GEOM)
    contiguous = _reference_streams(arch, "contiguous")
    paged = _reference_streams(arch, "paged")
    np.testing.assert_array_equal(report.a.value, contiguous)
    np.testing.assert_array_equal(report.b.value, paged)
    assert report.ok == bool(np.array_equal(contiguous, paged))


# ------------------------------------------------------------ entry points


@pytest.mark.parametrize("kernel", ["paged", "gather"])
def test_serve_cli_serves_moe_on_the_paged_engine(kernel, capsys):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--arch", "qwen3-moe-30b-a3b", "--requests",
          "6", "--slots", "2", "--max-new", "4", "--shared-prefix", "16",
          "--kernel", kernel])
    res = json.loads(capsys.readouterr().out)
    assert res["engine"] == "paged" and res["kernel"] == kernel
    assert res["served"] == 6 and res["prefix_hit_rate"] > 0


def test_train_cli_trains_and_resumes_moe(tmp_path):
    """granite-moe through the launcher: cut at the step-2 checkpoint and
    resumed, it reproduces the uninterrupted run's losses exactly."""
    from repro_torch.launch.train import train
    kw = dict(steps=4, total_steps=4, ckpt_every=2, seq_len=32,
              global_batch=2, device="cpu")
    arch = "granite-moe-1b-a400m"
    full = train(arch, out_dir=str(tmp_path / "full"), **kw)
    first = train(arch, out_dir=str(tmp_path / "cut"), **dict(kw, steps=2))
    resumed = train(arch, out_dir=str(tmp_path / "cut"), resume=True, **kw)
    assert full["arch"] == arch + "-smoke" and len(full["losses"]) == 4
    assert all(np.isfinite(full["losses"]))
    assert first["losses"] + resumed["losses"] == full["losses"]
    assert resumed["audit"]["trace"].get("ckpt-restore") == 1
