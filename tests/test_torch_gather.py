"""The port's gather pathway and ``compare_engines`` on the CPU, against the
reference.

* ``core.verify``: the port's copy is the reference's code, and on the same
  inputs gives the reference's verdicts.
* ``KVPool``: the same writes and reads give the reference's arrays; bf16
  pages cross the host as their raw bits, exactly.
* ``chunk_decode_attention`` / ``decode_chunk`` against the reference's
  layer functions run op by op (2 bf16 ulps of the logit scale; f32
  within 2e-5) and against its compiled step (8 ulps), as
  ``tests/test_torch_decode.py`` holds the paged step.
* ``PagedServeEngine(kernel="gather")`` token-exact against the
  reference's gather engine on ``tests/test_integration.py``'s workload,
  greedy (that engine is deterministic; the reference's contiguous engine
  is not, ROADMAP caveat a), and against the port's paged pathway, greedy
  and sampled; ``compare_engines`` ok for both pathways; preemption with
  swap-in or recompute, cancellation and report keys on the gather
  pathway; the serving CLI's ``--kernel gather``.
"""
import ast
import json
import inspect

import numpy as np
import pytest
import torch

from repro_torch.configs import ALL_ARCHS as T_ARCHS
from repro_torch.configs import reduced as t_reduced
from repro_torch.core import verify as tverify
from repro_torch.launch import serve as launcher
from repro_torch.models import build as t_build
from repro_torch.models import params as TP
from repro_torch.serve import (KVPool, PagedServeEngine, Request,
                               SamplingParams, compare_engines, token_matrix)

ARCH = "deepseek-7b"
GEOM = dict(slots=2, max_len=64, block_size=8, chunk=4)
LAYER_ULPS, COMPILED_ULPS = 2, 8     # as tests/test_torch_decode.py
F32_TOL = 2e-5
SAMPLED = dict(temperature=0.8, top_k=16, top_p=0.9, seed=2)


@pytest.fixture(scope="module")
def port():
    """Reduced deepseek-7b in the port, seeded weights on the CPU."""
    model = t_build(t_reduced(T_ARCHS[ARCH]))
    return model, model.init_params(torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(scope="module")
def bridged():
    """The reference's weights in both frameworks."""
    jax = pytest.importorskip("jax")
    from repro.configs import ALL_ARCHS, reduced
    from repro.models import build
    cfg = reduced(ALL_ARCHS[ARCH])
    model = build(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    return (model, params, t_build(t_reduced(T_ARCHS[ARCH])),
            TP.from_jax(jax.tree.map(np.asarray, params)))


def _workload(vocab):
    """``tests/test_integration.py:128``'s trace: a 16-token shared
    prefix, four tails of 3-6 tokens, 6 new tokens each."""
    rng = np.random.default_rng(11)
    shared = rng.integers(0, vocab, size=16).tolist()
    tails = [rng.integers(0, vocab, size=3 + i).tolist() for i in range(4)]
    return [(shared + tails[i], 6) for i in range(4)]


def _requests(work, cls=Request, sampling=None):
    return [cls(rid=i, prompt=list(p), max_new=n, sampling=sampling)
            for i, (p, n) in enumerate(work)]


# ------------------------------------------------------------ core.verify


def _code_without_docstring(module) -> str:
    tree = ast.parse(inspect.getsource(module))
    if isinstance(tree.body[0], ast.Expr):
        tree.body = tree.body[1:]
    return ast.dump(tree)


def test_verify_is_the_reference_code():
    pytest.importorskip("jax")
    from repro.core import verify as rverify
    assert _code_without_docstring(tverify) == _code_without_docstring(
        rverify)


# (a, b, rtol, atol): equal token matrices, one token off, a float drift
# inside and outside the band, a shape mismatch
VERDICT_CASES = [
    ([[1, 2, -1], [4, 5, 6]], [[1, 2, -1], [4, 5, 6]], 1e-9, 0.5),
    ([[1, 2, -1], [4, 5, 6]], [[1, 2, -1], [4, 7, 6]], 1e-9, 0.5),
    ([1.0, 2.0, 3.0], [1.0, 2.01, 3.0], 2e-2, 1e-5),
    ([1.0, 2.0, 3.0], [1.0, 2.2, 3.0], 2e-2, 1e-5),
    ([[1, 2]], [[1, 2, 3]], 1e-9, 0.5),
]


@pytest.mark.parametrize("case", range(len(VERDICT_CASES)))
def test_verify_gives_the_reference_verdicts(case):
    pytest.importorskip("jax")
    from repro.core import verify as rverify
    a, b, rtol, atol = VERDICT_CASES[case]
    # no timing band: a timing verdict on two sub-microsecond lambdas
    # would follow the host's noise (the code is held equal above)
    got, want = (mod.DualEnvHarness(repeats=2, warmup=1).compare(
        "a", lambda: np.asarray(a), "b", lambda: np.asarray(b),
        rtol=rtol, atol=atol)
        for mod in (tverify, rverify))
    assert got.ok == want.ok

    def numeric(report):    # repr: a shape mismatch measures nan
        return [(v.ok, v.detail, repr(v.measured), v.bound)
                for v in report.verdicts if v.kind == "numeric"]

    assert numeric(got) == numeric(want) and numeric(got)
    assert [v.kind for v in got.verdicts] == [v.kind for v in want.verdicts]
    assert set(got.summary()) == set(want.summary())
    assert len(got.a.wall_times) == len(want.a.wall_times) == 2


@pytest.mark.parametrize("overheads", [
    {1: 0.01}, {1: 0.01, 8: -0.015}, {1: 0.15, 8: 0.17}, {1: 0.1, 8: 0.5},
    {1: -0.2, 8: 0.3}, {2: 0.3, 4: 0.35, 16: 0.9}])
def test_overhead_classification_matches_reference(overheads):
    pytest.importorskip("jax")
    from repro.core import verify as rverify
    assert tverify.constant_vs_scaling_overhead(overheads) == (
        rverify.constant_vs_scaling_overhead(overheads))


# --------------------------------------------------------------- KVPool


def test_kv_pool_equals_reference():
    pytest.importorskip("jax")
    from repro.serve.paging import KVPool as RefKVPool
    rng = np.random.default_rng(0)
    shape = (3, 6, 4, 2, 8)       # layers, pages, block, kv, hd
    pools = [cls(6, 4, 3, 2, 8, np.float32) for cls in (KVPool, RefKVPool)]
    for bid in (4, 0, 2, 4):
        rows = [rng.standard_normal((3, 4, 2, 8)).astype(np.float32)
                for _ in range(2)]
        for pool in pools:
            pool.write(bid, *rows)
    for bids in ([4], [0, 2], [2, 4, 0], [5]):
        got, want = (pool.read(bids) for pool in pools)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert pools[0].k.shape == pools[1].k.shape == shape


def test_gather_pool_holds_bf16_rows_exactly(port):
    """A bf16 slot's rows registered into the host pool and gathered back
    into another slot come back bit for bit."""
    model, params = port
    eng = PagedServeEngine(model, params, kernel="gather", device="cpu",
                           **GEOM)
    kc = eng.cache["self"]["k"]
    assert kc.dtype == torch.bfloat16 and eng.pool.k.dtype == np.int16
    kc[:, 0, :8] = torch.randn(kc[:, 0, :8].shape).to(torch.bfloat16)
    from repro_torch.serve.paging import to_device, to_host
    eng.pool.write(3, to_host(kc[:, 0, :8]), to_host(kc[:, 0, :8]))
    k_rows, _ = eng.pool.read([3])
    kc[:, 1, :8] = to_device(k_rows, kc.dtype, kc.device)
    assert torch.equal(kc[:, 1, :8], kc[:, 0, :8])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_to_host_returns_a_copy_on_the_cpu(dtype):
    """``to_host`` of a CPU tensor (a whole cache and a strided slice of
    it) shares no memory with it: writing the source after the call
    leaves the returned array as it was."""
    from repro_torch.serve.paging import to_device, to_host
    cache = torch.randn(2, 3, 8, 4).to(dtype)
    for src in (cache, cache[:, 1, 2:6]):
        want = src.clone()
        got = to_host(src)
        src.fill_(7.0)
        assert torch.equal(to_device(got, dtype, src.device), want)


# -------------------------------------------------------- decode_chunk


def _close(got, want, ulps):
    """Within ``ulps`` bf16 ulps of the largest reference logit; argmax
    equal wherever the reference's top-2 gap exceeds twice that."""
    got, want = np.asarray(got), np.asarray(want)
    tol = ulps * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= tol
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    assert (got.argmax(-1) == want.argmax(-1))[clear].all()


def _chunk_inputs(cfg):
    """Three ticks over three lanes of a 24-row cache: prefill chunks, a
    decode lane, an idle lane, ragged chunk ends, and a lane whose chunk
    runs past the cache's end (its overflow rows are dropped)."""
    rng = np.random.default_rng(0)
    for pos, n_new in (([0, 0, 0], [4, 3, 0]), ([4, 3, 0], [1, 4, 2]),
                       ([5, 7, 22], [1, 1, 4])):
        toks = rng.integers(0, cfg.vocab_size, size=(3, 4)).astype(np.int32)
        yield toks, np.asarray(pos, np.int32), np.asarray(n_new, np.int32)


def _caches(model, tmodel, f32=False):
    """Zero dense caches of 3 lanes by 24 rows in both frameworks, in the
    spec's bf16 or in f32."""
    import jax.numpy as jnp
    spec = model.cache_specs(3, 24)["self"]
    jc = {k: jnp.zeros(s.shape, jnp.float32 if f32 else s.dtype)
          for k, s in spec.items()}
    tc = tmodel.zero_cache(3, 24, "cpu")
    if f32:
        tc = TP.tree_map(lambda t: t.float(), tc)
    return jc, tc


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_decode_chunk_matches_reference_layers(bridged, dtype):
    """The port's gather step against the reference's layer functions run
    op by op: logits at each lane's last real row (bf16: 2 ulps of the
    logit scale; f32 weights and cache: 2e-5) and the cache rows."""
    import jax
    import jax.numpy as jnp
    from repro.models.attention import chunk_decode_attention
    from repro.models.layers import embed_tokens, logits_from, rmsnorm, swiglu
    model, params, tmodel, tparams = bridged
    cfg = model.cfg
    f32 = dtype == "float32"
    if f32:
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        tparams = TP.tree_map(lambda t: t.float(), tparams)
    jc, tc = _caches(model, tmodel, f32)
    for toks, pos, n_new in _chunk_inputs(cfg):
        x = embed_tokens(params["embed"], jnp.asarray(toks))
        for i in range(cfg.n_layers):
            p = jax.tree.map(lambda a: a[i], params["layers"])
            y, k, v = chunk_decode_attention(
                cfg, p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                jc["k"][i], jc["v"][i], jnp.asarray(pos), jnp.asarray(n_new))
            jc["k"], jc["v"] = jc["k"].at[i].set(k), jc["v"].at[i].set(v)
            x = x + y
            x = x + swiglu(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps))
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        x = x[jnp.arange(3), jnp.maximum(jnp.asarray(n_new), 1) - 1][:, None]
        want = np.asarray(logits_from(params["embed"], cfg, x)[:, 0])
        got = tmodel.decode_chunk(tparams, tc, torch.tensor(toks),
                                  torch.tensor(pos), torch.tensor(n_new))
        assert got.shape == (3, cfg.padded_vocab)
        if f32:
            np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL,
                                       atol=F32_TOL)
        else:
            _close(got.numpy(), want, LAYER_ULPS)
    tol = F32_TOL if f32 else 2e-2
    for k in ("k", "v"):
        np.testing.assert_allclose(tc["self"][k].float().numpy(),
                                   np.asarray(jc[k].astype(jnp.float32)),
                                   rtol=tol, atol=tol)


def test_decode_chunk_within_compiled_reference(bridged):
    """Against the reference's compiled step, as its gather engine runs it;
    the sampled and greedy methods select from those logits."""
    import jax
    import jax.numpy as jnp
    model, params, tmodel, tparams = bridged
    step = jax.jit(model.decode_chunk)
    jc, tc = _caches(model, tmodel)
    jcache = {"self": jc}
    lane = {"temperature": torch.tensor([0.0, 0.8, 0.0]),
            "top_k": torch.tensor([0, 16, 0], dtype=torch.int32),
            "top_p": torch.tensor([1.0, 0.9, 1.0]),
            "seed": torch.tensor([0, 2, 0], dtype=torch.int32),
            "rid": torch.tensor([0, 1, 2], dtype=torch.int32),
            "step": torch.tensor([0, 0, 0], dtype=torch.int32)}
    for toks, pos, n_new in _chunk_inputs(model.cfg):
        want, jcache = step(params, jcache, *map(jnp.asarray,
                                                 (toks, pos, n_new)))
        args = [torch.tensor(a) for a in (toks, pos, n_new)]
        snapshot = {k: t.clone() for k, t in tc["self"].items()}
        got = tmodel.decode_chunk(tparams, tc, *args)
        _close(got.numpy(), want, COMPILED_ULPS)
        # the fused selections see the same logits (rewriting the same
        # rows of the same cache is idempotent)
        after = {k: t.clone() for k, t in tc["self"].items()}
        tc["self"].update({k: t.clone() for k, t in snapshot.items()})
        assert torch.equal(tmodel.decode_greedy_chunk(tparams, tc, *args),
                           got.argmax(-1))
        tc["self"].update({k: t.clone() for k, t in snapshot.items()})
        sampled = tmodel.decode_sample_chunk(tparams, tc, *args, lane)
        assert sampled[0] == got[0].argmax() and sampled[2] == got[2].argmax()
        assert all(torch.equal(tc["self"][k], after[k]) for k in after)


# ----------------------------------------------------------------- engine


def test_gather_engine_matches_reference_gather_engine(bridged):
    """Greedy, on the integration workload: the port's gather pathway
    equals the reference's gather pathway token for token."""
    from repro.serve.engine import PagedServeEngine as RefPaged
    from repro.serve.engine import Request as RefRequest
    from repro.serve.engine import token_matrix as ref_token_matrix
    model, params, tmodel, tparams = bridged
    work = _workload(model.cfg.vocab_size)
    ref_eng = RefPaged(model, params, kernel="gather", **GEOM)
    want = ref_token_matrix(ref_eng.run(_requests(work, RefRequest)), 4, 6)
    eng = PagedServeEngine(tmodel, tparams, kernel="gather", device="cpu",
                           **GEOM)
    got = token_matrix(eng.run(_requests(work)), 4, 6)
    assert (got >= 0).all()
    assert np.array_equal(got, want)
    rep, ref_rep = eng.report(), ref_eng.report()
    assert rep["kernel"] == ref_rep["kernel"] == "gather"
    for key in ("prefix_hit_rate", "cached_tokens", "prefill_tokens",
                "decode_steps", "prefix_insertions"):
        assert rep[key] == ref_rep[key], key


@pytest.mark.parametrize("sampled", [False, True])
def test_gather_matches_paged_pathway(port, sampled):
    model, params = port
    sp = SamplingParams(**SAMPLED) if sampled else None
    work = _workload(model.cfg.vocab_size)
    streams = {}
    for kernel in ("paged", "gather"):
        eng = PagedServeEngine(model, params, kernel=kernel, device="cpu",
                               **GEOM)
        streams[kernel] = token_matrix(eng.run(_requests(work, sampling=sp)),
                                       4, 6)
        rep = eng.report()
        assert rep["kernel"] == kernel and rep["prefix_hit_rate"] > 0
        eng.alloc.check()
        assert eng.alloc.in_use == len(eng.prefix)
    assert (streams["gather"] >= 0).all()
    assert np.array_equal(streams["gather"], streams["paged"])


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("kernel", ["paged", "gather"])
def test_compare_engines_holds_both_pathways(port, kernel, sampled):
    """The oracle verdict with the pathway pinned either way, greedy and
    sampled, as ``tests/test_integration.py`` asks of the reference."""
    model, params = port
    work = _workload(model.cfg.vocab_size)
    report = compare_engines(
        model, params, lambda: _requests(work), **GEOM,
        sampling=SamplingParams(**SAMPLED) if sampled else None,
        engine_kwargs={"paged": {"kernel": kernel}}, device="cpu")
    assert report.ok, report.summary()
    assert [v.kind for v in report.verdicts] == ["numeric"]
    assert report.a.value.shape == report.b.value.shape == (4, 6)


def test_compare_engines_refuses_a_cluster(port):
    model, params = port
    with pytest.raises(NotImplementedError, match="ClusterEngine"):
        compare_engines(model, params, lambda: [], cluster={"replicas": 2},
                        device="cpu")


def _preempt_once(model, params, sampling=None, **kw):
    """Tight single-slot gather engine: lo runs, hi preempts it, both
    finish; and the same two requests uninterrupted on ample slots."""
    rng = np.random.default_rng(11)
    lo_p = rng.integers(0, 50, 12).tolist()
    hi_p = rng.integers(50, 100, 8).tolist()
    eng = PagedServeEngine(model, params, slots=1, max_len=64, block_size=4,
                           num_blocks=10, chunk=4, kernel="gather",
                           device="cpu", **kw)
    lo = eng.submit(Request(rid=0, prompt=lo_p, max_new=16, priority=0,
                            sampling=sampling), arrival=0.0)
    for _ in range(4):
        eng.step()
    hi = eng.submit(Request(rid=1, prompt=hi_p, max_new=6, priority=5,
                            sampling=sampling))
    eng.drain()
    ref = PagedServeEngine(model, params, slots=2, max_len=64, block_size=4,
                           num_blocks=32, chunk=4, kernel="gather",
                           device="cpu")
    want = {r.rid: r.out for r in ref.run(
        [Request(rid=0, prompt=lo_p, max_new=16, sampling=sampling),
         Request(rid=1, prompt=hi_p, max_new=6, sampling=sampling)])}
    return eng, lo, hi, want


@pytest.mark.parametrize("sampled", [False, True])
def test_gather_swap_restore_equals_uninterrupted_run(port, sampled):
    """A preempted request's slot rows go to the host tier as pages and
    come back into its new slot bit for bit."""
    model, params = port
    sp = (SamplingParams(temperature=0.7, top_k=16, top_p=0.95, seed=13)
          if sampled else None)
    eng, lo, hi, want = _preempt_once(model, params, sp)
    rep = eng.report()
    assert rep["preemptions"] >= 1 and rep["swap_ins"] >= 1
    assert rep["restored_tokens"] > 0 and rep["recompute_tokens"] == 0
    assert lo.req.out == want[0] and hi.req.out == want[1]
    eng.alloc.check()
    eng.host.check()
    assert eng.host.in_use == 0      # no prefix spill on this pathway


def test_gather_swap_disabled_recomputes_and_stays_exact(port):
    model, params = port
    eng, lo, hi, want = _preempt_once(model, params, swap=False)
    rep = eng.report()
    assert rep["preemptions"] >= 1 and rep["swap_ins"] == 0
    assert rep["recompute_tokens"] > 0
    assert lo.req.out == want[0] and hi.req.out == want[1]
    eng.alloc.check()


@pytest.mark.parametrize("when", [0, 2, 6])
def test_gather_cancel_releases_every_page(port, when):
    model, params = port
    eng = PagedServeEngine(model, params, kernel="gather", device="cpu",
                           **GEOM)
    handles = [eng.submit(r) for r in _requests(
        _workload(model.cfg.vocab_size))]
    for _ in range(when):
        eng.step()
    assert handles[1].cancel()
    eng.drain()
    assert handles[1].cancelled and not handles[1].finished
    assert all(h.finished for i, h in enumerate(handles) if i != 1)
    eng.alloc.check()
    assert eng.alloc.in_use == len(eng.prefix)


def test_gather_report_keys_and_storage_match_reference(bridged):
    from repro.serve.engine import PagedServeEngine as RefPaged
    model, params, tmodel, tparams = bridged
    ref = RefPaged(model, params, kernel="gather", **GEOM)
    eng = PagedServeEngine(tmodel, tparams, kernel="gather", device="cpu",
                           **GEOM)
    assert set(eng.report()) == set(ref.report())
    assert eng.view is None and eng.pool is not None
    assert set(eng.cache) == set(ref.cache) == {"self"}
    assert tuple(eng.cache["self"]["k"].shape) == ref.cache["self"]["k"].shape
    assert eng.pool.k.shape == ref.pool.k.shape
    with pytest.raises(ValueError, match="kernel must be"):
        PagedServeEngine(tmodel, tparams, kernel="dense", device="cpu")


def test_cli_serves_the_gather_pathway(capsys):
    launcher.main(["--device", "cpu", "--requests", "4", "--slots", "2",
                   "--max-new", "4", "--shared-prefix", "16",
                   "--kernel", "gather"])
    out = json.loads(capsys.readouterr().out)
    assert out["served"] == 4 and out["engine"] == "paged"
    assert out["kernel"] == "gather" and out["prefix_hit_rate"] > 0
