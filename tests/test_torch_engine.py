"""The port's serving engines on the CPU, against the reference and against
each other.

* The port's ``PagedServeEngine`` against the reference's
  ``PagedServeEngine`` (not its contiguous ``ServeEngine``, whose serial
  prefill races on jax 0.9.0), greedy, on the workload of
  ``tests/test_integration.py``: token-exact streams.  The one accepted
  exception is a divergence at a tick where the reference's own top-2
  logit gap is below the logit tolerance; the test then shows that gap.
* Within the port: paged against contiguous, token-exact, greedy and
  sampled; prefix hits with a clean allocator; a preempt-and-swap-restore
  run equal to an uninterrupted one; cancellation; report keys.
* Entry points default to the GPU and raise without one.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import ALL_ARCHS as T_ARCHS
from repro_torch.configs import reduced as t_reduced
from repro_torch.launch import serve as launcher
from repro_torch.models import build as t_build
from repro_torch.serve import (PagedServeEngine, Request, SamplingParams,
                               ServeEngine, token_matrix)

ARCH = "deepseek-7b"
# the bf16 logit budget of a near tie (8 ulps at the reduced model's logit
# scale, the bound tests/test_torch_decode.py holds the compiled step to)
NEAR_TIE = 8 * 2.0 ** -6
GEOM = dict(slots=2, max_len=64, block_size=8, chunk=4)


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

    from repro_torch.models import params as TP
    cfg = reduced(ALL_ARCHS[ARCH])
    params = build(cfg).init_params(jax.random.PRNGKey(0))
    return (cfg, params, t_build(t_reduced(T_ARCHS[ARCH])),
            TP.from_jax(jax.tree.map(np.asarray, params)))


def _integration_workload(vocab):
    """``tests/test_integration.py``'s kernel-vs-oracle trace: a 16-token
    shared prefix, four tails of 3-6 tokens, 6 new tokens each."""
    rng = np.random.default_rng(11)
    shared = rng.integers(0, vocab, size=16).tolist()
    tails = [rng.integers(0, vocab, size=3 + i).tolist() for i in range(4)]
    return [(shared + tails[i], 6) for i in range(4)]


def _requests(work, cls=Request, sampling=None):
    return [cls(rid=i, prompt=list(p), max_new=n, sampling=sampling)
            for i, (p, n) in enumerate(work)]


def _ref_top2_gap(cfg, params, tokens):
    """The reference's top-2 logit gap after ``tokens`` (its own compiled
    single-token decode over a one-slot cache)."""
    import jax
    import jax.numpy as jnp
    from repro.models import build
    model = build(cfg)
    step = jax.jit(model.decode_step)
    cache = model.zero_cache(1, len(tokens) + 1)
    for i, t in enumerate(tokens):
        logits, cache = step(params, cache, jnp.asarray([[t]], jnp.int32),
                             jnp.asarray([i], jnp.int32))
    top2 = np.sort(np.asarray(logits[0]))[-2:]
    return float(top2[1] - top2[0])


def test_paged_engine_matches_reference_paged_engine(bridged):
    from repro.serve.engine import PagedServeEngine as RefPaged
    from repro.serve.engine import Request as RefRequest
    from repro.serve.engine import token_matrix as ref_token_matrix
    cfg, params, tmodel, tparams = bridged
    work = _integration_workload(cfg.vocab_size)
    from repro.models import build
    ref = ref_token_matrix(RefPaged(build(cfg), params, **GEOM).run(
        _requests(work, RefRequest)), 4, 6)
    eng = PagedServeEngine(tmodel, tparams, device="cpu", **GEOM)
    got = token_matrix(eng.run(_requests(work)), 4, 6)
    assert eng.report()["prefix_hit_rate"] > 0
    assert (got >= 0).all()
    for rid in np.flatnonzero((got != ref).any(axis=1)):
        t = int(np.flatnonzero(got[rid] != ref[rid])[0])
        prompt, _ = work[rid]
        gap = _ref_top2_gap(cfg, params, prompt + ref[rid, :t].tolist())
        assert gap < NEAR_TIE, (
            f"request {rid} diverges at token {t} where the reference's "
            f"top-2 gap {gap:.4f} is not a near tie (< {NEAR_TIE})")
        print(f"request {rid}: near-tie divergence at token {t}, "
              f"reference top-2 gap {gap:.4f}")


@pytest.mark.parametrize("sampled", [False, True])
def test_paged_matches_contiguous(port, sampled):
    """Within the port, the paged engine reproduces the contiguous oracle's
    streams token for token, greedy and sampled (noise keyed on
    (seed, rid, step), never on slot or schedule)."""
    model, params = port
    sp = (SamplingParams(temperature=0.8, top_k=16, top_p=0.9, seed=2)
          if sampled else None)
    work = _integration_workload(model.cfg.vocab_size)
    paged = PagedServeEngine(model, params, device="cpu", **GEOM)
    got = token_matrix(paged.run(_requests(work, sampling=sp)), 4, 6)
    contiguous = ServeEngine(model, params, slots=2, max_len=64,
                             device="cpu")
    want = token_matrix(contiguous.run(_requests(work, sampling=sp)), 4, 6)
    assert (got >= 0).all()
    assert (got == want).all()
    rep = paged.report()
    assert rep["prefix_hit_rate"] > 0 and rep["cached_tokens"] > 0
    paged.alloc.check()
    assert paged.alloc.in_use == len(paged.prefix)   # only cached pages left


def _preempt_once(model, params, sampling=None, **kw):
    """Tight single-slot engine: lo runs, hi preempts it, both finish."""
    rng = np.random.default_rng(11)
    lo_p = rng.integers(0, 50, 12).tolist()
    hi_p = rng.integers(50, 100, 8).tolist()
    eng = PagedServeEngine(model, params, slots=1, max_len=64, block_size=4,
                           num_blocks=10, chunk=4, device="cpu", **kw)
    lo = eng.submit(Request(rid=0, prompt=lo_p, max_new=16, priority=0,
                            sampling=sampling), arrival=0.0)
    for _ in range(4):
        eng.step()
    hi = eng.submit(Request(rid=1, prompt=hi_p, max_new=6, priority=5,
                            sampling=sampling))
    eng.drain()
    ref = PagedServeEngine(model, params, slots=2, max_len=64, block_size=4,
                           num_blocks=32, chunk=4, device="cpu")
    want = {r.rid: r.out for r in ref.run(
        [Request(rid=0, prompt=lo_p, max_new=16, sampling=sampling),
         Request(rid=1, prompt=hi_p, max_new=6, sampling=sampling)])}
    return eng, lo, hi, want


@pytest.mark.parametrize("sampled", [False, True])
def test_swap_restore_equals_uninterrupted_run(port, sampled):
    """A preempted request's pages go to the host tier and come back bit
    for bit: its stream equals an uninterrupted run's."""
    model, params = port
    sp = (SamplingParams(temperature=0.7, top_k=16, top_p=0.95, seed=13)
          if sampled else None)
    eng, lo, hi, want = _preempt_once(model, params, sp)
    rep = eng.report()
    assert rep["preemptions"] >= 1
    assert rep["swap_ins"] >= 1 and rep["restored_tokens"] > 0
    assert rep["recompute_tokens"] == 0 and rep["swap_restore_rate"] == 1.0
    assert lo.req.out == want[0] and hi.req.out == want[1]
    eng.alloc.check()
    eng.host.check()
    assert eng.host.in_use == eng.prefix.spilled


def test_swap_disabled_recomputes_and_stays_exact(port):
    model, params = port
    eng, lo, hi, want = _preempt_once(model, params, swap=False)
    rep = eng.report()
    assert rep["preemptions"] >= 1 and rep["swap_ins"] == 0
    assert rep["recompute_tokens"] > 0
    assert lo.req.out == want[0] and hi.req.out == want[1]
    eng.alloc.check()


def test_page_round_trip_through_host_is_bit_exact(port):
    model, params = port
    eng = PagedServeEngine(model, params, device="cpu", **GEOM)
    eng.view.k[:, 3] = torch.randn(eng.view.k[:, 3].shape).to(torch.bfloat16)
    k_rows, v_rows = eng.view.read_page(3)
    eng.view.write_page(5, k_rows, v_rows)
    assert torch.equal(eng.view.k[:, 5], eng.view.k[:, 3])
    assert torch.equal(eng.view.v[:, 5], eng.view.v[:, 3])


@pytest.mark.parametrize("when", [0, 2, 6])
def test_cancel_releases_every_page(port, when):
    """Cancel waiting, mid-prefill or mid-decode: the slot and all page
    references go; only prefix-cache pages stay in use."""
    model, params = port
    eng = PagedServeEngine(model, params, device="cpu", **GEOM)
    work = _integration_workload(model.cfg.vocab_size)
    handles = [eng.submit(r) for r in _requests(work)]
    for _ in range(when):
        eng.step()
    assert handles[1].cancel()
    eng.drain()
    assert handles[1].cancelled and not handles[1].finished
    assert all(h.finished for i, h in enumerate(handles) if i != 1)
    eng.alloc.check()
    assert eng.alloc.in_use == len(eng.prefix)
    assert eng.report()["cancelled"] == 1


def test_report_keys_match_reference(bridged):
    """Both engines report the reference's keys (the audit rules read
    them unchanged); the port compiles nothing."""
    from repro.models import build
    from repro.serve.engine import PagedServeEngine as RefPaged
    from repro.serve.engine import Request as RefRequest
    from repro.serve.engine import ServeEngine as RefServe
    cfg, params, tmodel, tparams = bridged
    work = _integration_workload(cfg.vocab_size)[:1]
    pairs = ((RefPaged(build(cfg), params, **GEOM),
              PagedServeEngine(tmodel, tparams, device="cpu", **GEOM)),
             (RefServe(build(cfg), params, slots=2, max_len=64),
              ServeEngine(tmodel, tparams, slots=2, max_len=64,
                          device="cpu")))
    for ref, eng in pairs:
        ref.run(_requests(work, RefRequest))
        eng.run(_requests(work))
        assert set(eng.report()) == set(ref.report())
        assert eng.report()["compiles"] == 0
        assert eng.report()["tokens_out"] == ref.report()["tokens_out"]


def test_only_the_paged_kernel_pathway_exists(port):
    """The paged engine has the reference's two KV pathways, the page-table
    kernel (the default) and the gather fallback, and refuses any other
    (tests/test_torch_gather.py holds the gather one)."""
    model, params = port
    assert PagedServeEngine(model, params, device="cpu",
                            **GEOM).report()["kernel"] == "paged"
    with pytest.raises(ValueError, match="kernel must be 'paged'"):
        PagedServeEngine(model, params, kernel="flash", device="cpu")


def test_engines_refuse_parameters_on_another_device(port):
    model, params = port
    with pytest.raises(ValueError, match="parameters live on"):
        PagedServeEngine(model, params, device="meta")


def test_entry_points_default_to_the_gpu_and_raise_without_one(port):
    """Built without ``device=``, an engine (and the CLI) asks for CUDA and
    raises where there is none; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    model, params = port
    for make in (lambda: PagedServeEngine(model, params),
                 lambda: ServeEngine(model, params),
                 lambda: launcher.main(["--requests", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_cli_serves_on_the_cpu_when_asked(capsys):
    launcher.main(["--device", "cpu", "--requests", "3", "--slots", "1",
                   "--max-new", "4",
                   "--shared-prefix", "16", "--temperature", "0.8",
                   "--top-k", "20"])
    out = json.loads(capsys.readouterr().out)
    assert out["served"] == 3 and out["engine"] == "paged"
    assert out["device"] == "cpu" and out["kernel"] == "paged"
    assert out["prefix_hit_rate"] > 0
    assert out["trace"]["first-token"] == 3
