"""The port's ``ClusterEngine`` on the CPU, within the port and against the
reference's cluster.

* Routing machinery without a model: summaries, match depth, policies.
* Within the port, reduced deepseek-7b at ``tests/test_cluster.py``'s
  geometry: every routing policy reproduces one ``PagedServeEngine``'s
  streams token for token, greedy and sampled; affinity converts its
  opportunities and random does not; Bloom routing equals exact routing;
  a stale summary view stays token-exact; a request cancelled before its
  arrival is cancelled unrouted; construction and submit refusals.
* Against the reference, on the chat smoke trace with 3 replicas and the
  reference's weights (``params.from_jax``): the same routing decisions,
  event for event, the same routing counters and report keys, and token
  streams that agree or part only at a reference near tie.
* On the card (``cuda``): 2 replicas token-exact against one engine.
"""
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from test_torch_engine import NEAR_TIE, _ref_top2_gap
from repro_torch.audit import Tracer
from repro_torch.configs import ALL_ARCHS as T_ARCHS
from repro_torch.configs import reduced as t_reduced
from repro_torch.models import build as t_build
from repro_torch.serve import (AffinityPolicy, BloomSummary, ClusterEngine,
                               ExactSummary, PagedServeEngine, RandomPolicy,
                               Request, RoundRobinPolicy, SamplingParams,
                               chain_hashes, compare_engines, generate,
                               make_policy, match_depth, smoke_specs,
                               token_matrix)

ARCH = "deepseek-7b"
GEOM = dict(slots=2, max_len=48, block_size=8, chunk=4)
MAX_NEW = 4
SAMPLED = SamplingParams(temperature=0.8, top_k=16, seed=9)
ROUTE_KEYS = ("rid", "replica", "decision", "depth", "best_depth")
ROUTING_COUNTERS = ("routed", "affine_opportunities", "routed_affinity",
                    "routed_spills", "routed_cold", "summary_rebuilds",
                    "prefill_tokens", "cached_tokens", "shared_hit_rate")


@pytest.fixture(scope="module")
def port():
    """Reduced deepseek-7b in the port, seeded weights on the CPU."""
    model = t_build(t_reduced(T_ARCHS[ARCH]))
    return model, model.init_params(torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(scope="module")
def chat_trace(port):
    model, _ = port
    return generate(smoke_specs(vocab_size=model.cfg.vocab_size, seed=0)[0])


def _requests(trace, sampling=None):
    reqs = trace.requests()
    for r in reqs:
        r.max_new = MAX_NEW
        r.sampling = sampling
    return reqs


def _run(eng, trace, sampling=None):
    n = trace.n_requests
    return token_matrix(eng.run(_requests(trace, sampling),
                                arrivals=list(trace.arrivals)), n, MAX_NEW)


@pytest.fixture(scope="module")
def single_streams(port, chat_trace):
    """One paged engine's streams, greedy and sampled: the oracle."""
    model, params = port
    return {name: _run(PagedServeEngine(model, params, device="cpu", **GEOM),
                       chat_trace, sp)
            for name, sp in (("greedy", None), ("sampled", SAMPLED))}


# ------------------------------------------------------------- machinery


def test_summaries_and_match_depth():
    s = ExactSummary()
    for h in (3, 99, 2**63):
        s.add(h)
    assert 3 in s and 2**63 in s and 7 not in s and len(s) == 3
    bloom = BloomSummary(bits=4096, k=3)
    rng = np.random.default_rng(0)
    member = [int(h) for h in rng.integers(0, 2**63, size=64)]
    for h in member:
        bloom.add(h)
    assert all(h in bloom for h in member)       # never a false negative
    probe = [int(h) for h in rng.integers(0, 2**63, size=2000)]
    assert sum(h not in member and h in bloom for h in probe) < 100
    for bad in (dict(bits=0), dict(k=9)):
        with pytest.raises(ValueError):
            BloomSummary(**bad)
    hashes = chain_hashes(list(range(32)), 8)
    holed = ExactSummary()
    holed.add(hashes[0])
    holed.add(hashes[2])
    assert match_depth(holed, hashes) == 1        # a hole stops the walk
    assert match_depth(ExactSummary(), hashes) == 0


class _FakeReplica:
    def __init__(self, idx, load, slots=2):
        self.idx, self.load, self.slots = idx, load, slots


@pytest.mark.parametrize("depths,loads,want", [
    ([1, 3, 2], [0, 0, 0], (1, "affine")),      # deepest match
    ([0, 0, 0], [5, 1, 2], (1, "cold")),        # least loaded
    ([2, 0], [4, 0], (1, "spill")),             # saturated: 4 >= 2.0 x 2
    ([2, 0], [3, 0], (0, "affine")),            # not saturated
])
def test_affinity_policy(depths, loads, want):
    reps = [_FakeReplica(i, load) for i, load in enumerate(loads)]
    assert AffinityPolicy().choose(None, depths, reps) == want


def test_make_policy_and_placement_blind_policies():
    assert isinstance(make_policy("affinity"), AffinityPolicy)
    assert isinstance(make_policy("round_robin"), RoundRobinPolicy)
    assert isinstance(make_policy("random", seed=3), RandomPolicy)
    pol = AffinityPolicy(spill_factor=3.0)
    assert make_policy(pol) is pol
    with pytest.raises(ValueError):
        make_policy("nearest")
    reps = [_FakeReplica(i, 0) for i in range(3)]
    rr = RoundRobinPolicy()
    assert [rr.choose(None, [0] * 3, reps)[0] for _ in range(6)] == [
        0, 1, 2, 0, 1, 2]
    a, b = make_policy("random", seed=5), make_policy("random", seed=5)
    picks = [a.choose(None, [0] * 3, reps)[0] for _ in range(8)]
    assert picks == [b.choose(None, [0] * 3, reps)[0] for _ in range(8)]
    assert len(set(picks)) > 1


# ------------------------------------------------------ within the port


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("routing", ["affinity", "round_robin", "random"])
def test_cluster_token_exact_vs_single_engine(port, chat_trace,
                                              single_streams, routing,
                                              sampled):
    """Requests are routed whole and sampled tokens key on (seed, rid,
    step): every policy reproduces one engine's streams exactly."""
    model, params = port
    eng = ClusterEngine(model, params, replicas=3, routing=routing,
                        routing_seed=11, device="cpu", **GEOM)
    got = _run(eng, chat_trace, SAMPLED if sampled else None)
    want = single_streams["sampled" if sampled else "greedy"]
    assert (got >= 0).all() and (got == want).all()
    for r in eng.replicas:
        r.alloc.check()
        r.host.check()


def test_compare_engines_cluster_form(port, chat_trace):
    model, params = port
    rep = compare_engines(model, params, lambda: _requests(chat_trace),
                          sampling=SAMPLED, cluster={"replicas": 3},
                          device="cpu", **GEOM)
    assert rep.ok, rep.summary()["verdicts"]


def test_affinity_beats_random(port, chat_trace):
    model, params = port

    def report(routing):
        eng = ClusterEngine(model, params, replicas=3, routing=routing,
                            routing_seed=11, device="cpu", **GEOM)
        _run(eng, chat_trace)
        return eng.report()

    healthy, misrouted = report("affinity"), report("random")
    assert healthy["affine_opportunities"] > 0
    assert healthy["routed_affinity"] == 1.0
    assert misrouted["routed_affinity"] < healthy["routed_affinity"]
    assert misrouted["shared_hit_rate"] < healthy["shared_hit_rate"]


def test_bloom_routing_matches_exact_and_staleness_stays_exact(
        port, chat_trace, single_streams):
    model, params = port

    def decisions(**kw):
        tr = Tracer()
        eng = ClusterEngine(model, params, replicas=3, tracer=tr,
                            device="cpu", **kw, **GEOM)
        got = _run(eng, chat_trace)
        return [(e.data["rid"], e.data["replica"])
                for e in tr.events("route")], got, eng.report()

    exact, _, _ = decisions(summary="exact")
    bloom, _, _ = decisions(summary="bloom")
    assert exact == bloom
    _, stale, rep = decisions(refresh_every=7)
    assert (stale == single_streams["greedy"]).all()
    assert rep["summary_rebuilds"] >= 1


def test_cancel_unrouted_request_before_arrival(port, chat_trace):
    model, params = port
    tr = Tracer()
    eng = ClusterEngine(model, params, replicas=2, tracer=tr, device="cpu",
                        **GEOM)
    req = _requests(chat_trace)[0]
    handle = eng.submit(req, arrival=100.0)      # never routed
    assert eng.has_work()
    assert handle.cancel() is True
    assert req.cancelled and not eng.has_work()
    assert handle.cancel() is False
    rep = eng.report()
    assert rep["cancelled"] == 1 and rep["routed"] == 0
    ev = tr.last("cancel")
    assert ev.data["phase"] == "waiting" and ev.data["released_pages"] == 0


@pytest.mark.parametrize("kw", [
    dict(replicas=0), dict(replicas=2, summary="lossy"),
    dict(replicas=2, refresh_every=0), dict(replicas=2, routing="nearest"),
    dict(replicas=2, replica_tracers=[Tracer()]),
], ids=["replicas", "summary", "refresh", "routing", "tracers"])
def test_cluster_refuses_bad_construction(port, kw):
    model, params = port
    with pytest.raises(ValueError):
        ClusterEngine(model, params, device="cpu", **kw, **GEOM)


def test_cluster_refuses_unplaceable_request_and_a_missing_card(port):
    model, params = port
    eng = ClusterEngine(model, params, replicas=2, device="cpu", **GEOM)
    with pytest.raises(ValueError, match="pages even fully recomputed"):
        eng.submit(Request(rid=0, prompt=[1], max_new=200))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request(rid=1, prompt=[], max_new=2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ClusterEngine(model, params, replicas=2, **GEOM)


def test_cluster_report_aggregates_replicas(port, chat_trace):
    model, params = port
    eng = ClusterEngine(model, params, replicas=3, device="cpu", **GEOM)
    _run(eng, chat_trace)
    rep = eng.report()
    n = chat_trace.n_requests
    assert rep["engine"] == "cluster" and rep["replica_engine"] == "paged"
    assert rep["served"] == n and rep["routed"] == n
    per = rep["per_replica"]
    assert len(per) == 3
    for key in ("served", "tokens_out", "prefill_tokens", "cached_tokens",
                "decode_steps", "preemptions", "pages"):
        assert rep[key] == sum(p[key] for p in per), key
    assert rep["compiles"] == 0          # eager PyTorch compiles nothing
    total = rep["prefill_tokens"] + rep["cached_tokens"]
    assert rep["shared_hit_rate"] == pytest.approx(
        rep["cached_tokens"] / total, abs=1e-3)


# ------------------------------------------------- against the reference


def test_cluster_routes_as_the_reference(chat_trace):
    """Routing is discrete and depends only on prompts and loads, so the
    two clusters make the same decisions, event for event."""
    jax = pytest.importorskip("jax")
    from repro.audit import Tracer as RefTracer
    from repro.configs import ALL_ARCHS, reduced
    from repro.models import build
    from repro.serve import ClusterEngine as RefCluster
    from repro.serve import generate as ref_generate
    from repro.serve import smoke_specs as ref_smoke_specs
    from repro.serve import token_matrix as ref_token_matrix

    from repro_torch.models import params as TP
    cfg = reduced(ALL_ARCHS[ARCH])
    ref_params = build(cfg).init_params(jax.random.PRNGKey(0))
    ref_trace = ref_generate(ref_smoke_specs(vocab_size=cfg.vocab_size,
                                             seed=0)[0])
    assert ref_trace.prompts == chat_trace.prompts
    n = chat_trace.n_requests

    ref_tr = RefTracer()
    ref_eng = RefCluster(build(cfg), ref_params, replicas=3, tracer=ref_tr,
                         **GEOM)
    reqs = ref_trace.requests()
    for r in reqs:
        r.max_new = MAX_NEW
    want = ref_token_matrix(ref_eng.run(reqs,
                                        arrivals=list(ref_trace.arrivals)),
                            n, MAX_NEW)

    tr = Tracer()
    eng = ClusterEngine(t_build(t_reduced(T_ARCHS[ARCH])),
                        TP.from_jax(jax.tree.map(np.asarray, ref_params)),
                        replicas=3, tracer=tr, device="cpu", **GEOM)
    got = _run(eng, chat_trace)

    def routes(tracer):
        return [tuple(e.data[k] for k in ROUTE_KEYS)
                for e in tracer.events("route")]

    assert len(routes(tr)) == n and routes(tr) == routes(ref_tr)
    rep, ref_rep = eng.report(), ref_eng.report()
    assert {k: rep[k] for k in ROUTING_COUNTERS} == {
        k: ref_rep[k] for k in ROUTING_COUNTERS}
    assert rep["affine_opportunities"] > 0
    assert set(rep) == set(ref_rep)
    assert (got >= 0).all()
    for rid in np.flatnonzero((got != want).any(axis=1)):
        t = int(np.flatnonzero(got[rid] != want[rid])[0])
        gap = _ref_top2_gap(cfg, ref_params,
                            chat_trace.prompts[rid] + want[rid, :t].tolist())
        assert gap < NEAR_TIE, (
            f"request {rid} diverges at token {t} where the reference's "
            f"top-2 gap {gap:.4f} is not a near tie (< {NEAR_TIE})")


# ------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the paged kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_cuda_cluster_token_exact_vs_single_engine(cuda, chat_trace):
    """Two replicas on the card, each launching the paged kernel, give one
    engine's streams, greedy and sampled."""
    from repro_torch.kernels import ops
    model = t_build(t_reduced(T_ARCHS[ARCH]))
    params = model.init_params(torch.Generator(device=cuda).manual_seed(0),
                               cuda)
    for sp in (None, SAMPLED):
        want = _run(PagedServeEngine(model, params, device=cuda, **GEOM),
                    chat_trace, sp)
        ops.reset_launches()
        eng = ClusterEngine(model, params, replicas=2, device=cuda, **GEOM)
        got = _run(eng, chat_trace, sp)
        assert (got >= 0).all() and (got == want).all()
        steps = sum(r.report()["decode_steps"] for r in eng.replicas)
        assert ops.LAUNCHES["paged_attention"] == steps * model.cfg.n_layers
