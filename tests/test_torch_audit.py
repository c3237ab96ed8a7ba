"""The port's audit layer judging the port's engines, and the serve CLI
that carries it.

* Seeded misconfigurations (``tests/test_audit.py``'s): the gather
  pathway, a shrunk page size, a disabled prefix cache and the contiguous
  fallback each leave the streams equal to the healthy run's, yet the
  audit flags each at error severity; the healthy run audits clean.  The
  oracle is the port's own contiguous engine, which is deterministic.
* ``DEFAULT_REGISTRY`` judges a port cluster as paged, and a routing rule
  flags random routing, and only it, with ``pathway-routing``.
* The packages export what the reference's export.
* The CLI: cluster keys with the gate passed, a Chrome trace with one
  timeline per request, a bound metrics port, and ``--trace-out`` refused
  without the audit.
"""
import json

import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
import repro_torch.audit
import repro_torch.serve
from repro_torch.audit import (DEFAULT_REGISTRY, AuditContext, Evidence,
                               ExpectationRegistry, ExpectedSignature, Rule,
                               RunAudit, Tracer)
from repro_torch.configs import ALL_ARCHS, reduced
from repro_torch.launch import serve as launcher
from repro_torch.models import build
from repro_torch.serve import (ClusterEngine, PagedServeEngine, Request,
                               ServeEngine, compare_engines, generate,
                               smoke_specs, token_matrix)

GEOM = dict(slots=2, max_len=48, block_size=8, chunk=4)


@pytest.fixture(scope="module")
def port():
    cfg = reduced(ALL_ARCHS["deepseek-7b"])
    model = build(cfg)
    return cfg, model, model.init_params(torch.Generator().manual_seed(0),
                                         "cpu")


def _integration_requests(vocab):
    """``tests/test_audit.py``'s trace: a 16-token shared prefix, four
    tails of 3-6 tokens, 4 new tokens each."""
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, vocab, size=16).tolist()
    tails = [rng.integers(0, vocab, size=3 + i).tolist() for i in range(4)]
    return [Request(rid=i, prompt=prefix + tails[i], max_new=4)
            for i in range(4)]


SEEDS = {
    "pathway-kernel": dict(kernel="gather"),
    "pathway-page-geometry": dict(block_size=2),
    "pathway-prefix-cache": dict(use_prefix_cache=False),
    "pathway-engine-selection": None,          # the contiguous fallback
}


@pytest.fixture(scope="module")
def healthy(port):
    cfg, model, params = port
    make = lambda: _integration_requests(cfg.vocab_size)  # noqa: E731
    assert compare_engines(model, params, make, device="cpu", **GEOM).ok
    audit = RunAudit(AuditContext(workload="serve", family=cfg.family,
                                  arch=cfg.name, shared_prefix=True))
    eng = PagedServeEngine(model, params, tracer=audit.tracer, device="cpu",
                           **GEOM)
    tokens = token_matrix(eng.run(make()), 4, 4)
    assert eng.pstats.cached_tokens > 0
    assert audit.evaluate(engine_report=eng.report()) == []
    return tokens, eng.report()


@pytest.mark.parametrize("kind", list(SEEDS))
def test_seeded_misconfiguration_flagged_while_streams_stay(port, healthy,
                                                            kind):
    cfg, model, params = port
    audit = RunAudit(AuditContext(workload="serve", family=cfg.family,
                                  arch=cfg.name, shared_prefix=True))
    if SEEDS[kind] is None:
        eng = ServeEngine(model, params, slots=2, max_len=48,
                          tracer=audit.tracer, device="cpu")
    else:
        eng = PagedServeEngine(model, params, tracer=audit.tracer,
                               device="cpu", **{**GEOM, **SEEDS[kind]})
    tokens = token_matrix(eng.run(_integration_requests(cfg.vocab_size)),
                          4, 4)
    assert (tokens == healthy[0]).all()
    findings = audit.evaluate(engine_report=eng.report())
    hits = [f for f in findings if f["kind"] == kind]
    assert hits and all(f["severity"] == "error" for f in hits), findings
    if kind == "pathway-prefix-cache":
        assert eng.pstats.cached_tokens == 0
        assert eng.pstats.prefill_tokens > healthy[1]["prefill_tokens"]


@pytest.fixture(scope="module")
def chat_runs(port):
    """The chat smoke trace through 3-replica clusters under affinity and
    random routing: their streams, reports and tracers."""
    cfg, model, params = port
    trace = generate(smoke_specs(vocab_size=cfg.vocab_size, seed=0)[0])
    runs = {}
    for routing in ("affinity", "round_robin", "random"):
        tr = Tracer()
        eng = ClusterEngine(model, params, replicas=3, routing=routing,
                            routing_seed=11, tracer=tr, device="cpu", **GEOM)
        reqs = trace.requests()
        for r in reqs:
            r.max_new = 4
        done = eng.run(reqs, arrivals=list(trace.arrivals))
        runs[routing] = (token_matrix(done, trace.n_requests, 4),
                         eng.report(), tr)
    return runs


def test_default_registry_judges_a_cluster_as_paged(port, chat_runs):
    cfg, _, _ = port
    _, rep, tr = chat_runs["affinity"]
    ctx = AuditContext(workload="serve", family=cfg.family, arch=cfg.name,
                       shared_prefix=True)
    assert DEFAULT_REGISTRY.evaluate(
        ctx, Evidence(tracer=tr, engine_report=rep)) == []


def test_routing_rule_flags_random_routing_only(port, chat_runs):
    cfg, _, _ = port
    streams, healthy, _ = chat_runs["affinity"]
    rule = Rule(name="t-routing", workloads=("serve",),
                expect=ExpectedSignature(
                    min_routed_affinity=0.8 * healthy["routed_affinity"],
                    min_shared_hit_rate=0.85 * healthy["shared_hit_rate"]))
    reg = ExpectationRegistry([rule])
    ctx = AuditContext(workload="serve", family=cfg.family, arch=cfg.name,
                       shared_prefix=True)
    kinds = {routing: [f["kind"] for f in reg.evaluate(
        ctx, Evidence(engine_report=rep))]
        for routing, (_, rep, _) in chat_runs.items()}
    assert kinds["affinity"] == [] and kinds["round_robin"] == []
    assert kinds["random"] and set(kinds["random"]) == {"pathway-routing"}
    for routing, (got, _, _) in chat_runs.items():
        assert (got == streams).all(), routing


@pytest.mark.parametrize("pkg", ["serve", "audit"])
def test_package_exports_equal_the_reference(pkg):
    pytest.importorskip("jax")
    import importlib
    ref = importlib.import_module(f"repro.{pkg}")
    ours = getattr(repro_torch, pkg)
    assert sorted(ours.__all__) == sorted(ref.__all__)
    assert all(hasattr(ours, name) for name in ours.__all__)


# ------------------------------------------------------------------ CLI


def _cli(capsys, *argv):
    launcher.main(["--device", "cpu", "--requests", "6", "--slots", "2",
                   "--max-new", "4", "--shared-prefix", "16", *argv])
    return json.loads(capsys.readouterr().out)


def test_cli_serves_a_cluster(capsys, tmp_path):
    """Two replicas behind affinity routing: the cluster keys, the gate
    passed, a Chrome trace with one timeline per request, and the live
    endpoint's bound port."""
    path = tmp_path / "trace.json"
    out = _cli(capsys, "--replicas", "2", "--trace-out", str(path),
               "--metrics-port", "0")
    assert out["engine"] == "cluster" and out["replicas"] == 2
    assert out["routing"] == "affinity" and out["kernel"] == "paged"
    for key in ("routed", "routed_affinity", "routed_spills",
                "shared_hit_rate", "prefix_hit_rate", "preemptions",
                "summary_rebuilds", "attribution"):
        assert key in out, key
    assert out["served"] == out["routed"] == 6
    assert out["audit"]["gate_ok"] and out["audit"]["findings"] == []
    assert out["audit"]["trace"]["route"] == 6
    trace = json.loads(path.read_bytes())
    assert out["trace_out"] == {"path": str(path), "requests": 6,
                                "bytes": path.stat().st_size}
    assert trace["otherData"]["requests"] == 6
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert {e["args"]["rid"] for e in spans} == set(range(6))
    assert {e["pid"] for e in spans} == {0, 1}          # one per replica
    # the front tracer sees no finish (the replicas' labelled series do)
    assert out["metrics"]["port"] > 0


def test_cli_refuses_trace_out_without_the_audit(tmp_path):
    with pytest.raises(ValueError, match="--no-audit"):
        launcher.main(["--device", "cpu", "--no-audit", "--trace-out",
                       str(tmp_path / "t.json")])


def test_cli_flags_a_disabled_prefix_cache(capsys):
    """``--no-prefix-cache`` on a shared-prefix run: the gate fails with a
    ``pathway-prefix-cache`` error and the process exits 1."""
    with pytest.raises(SystemExit) as exit_:
        _cli(capsys, "--no-prefix-cache", "--no-swap")
    assert exit_.value.code == 1
    out = json.loads(capsys.readouterr().out)
    assert not out["audit"]["gate_ok"] and out["cached_tokens"] == 0
    assert out["swap"] is False
    assert out["max_ttft_ticks"] >= out["mean_ttft_ticks"] > 0
    assert [f["kind"] for f in out["audit"]["findings"]] == [
        "pathway-prefix-cache"]
