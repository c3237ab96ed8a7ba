"""Serving CLI of the port: the paged engine over a smoke-scale model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \\
        --requests 8 --slots 4 [--temperature 0.8 --top-k 20 --top-p 0.95]

Mirrors ``repro.launch.serve`` flag for flag, and adds ``--device``.  Like
the reference it serves ``reduced(arch)`` with seeded random weights (here
from a ``torch.Generator``).  Runs on the GPU unless ``--device cpu`` is
given, and fails when asked for a GPU that is not there.  ``--engine
contiguous`` serves through the oracle engine; the ssm, hybrid, vlm and
encdec archs (``mamba2-2.7b``, ``zamba2-2.7b``, ``llama-3.2-vision-11b``,
``whisper-medium``) always do, as in the reference, and the report's
``engine`` says which ran; the dense and moe archs serve through the paged
engine.  ``--kernel gather`` serves the paged engine
through its dense working-cache pathway instead of the page table (the
report's ``kernel`` says which).

``--replicas N`` (N > 1) serves through ``serve.cluster.ClusterEngine``:
N paged replicas behind prefix-affinity routing (``--routing`` picks the
policy; ``random`` misroutes on purpose, so the ``pathway-routing``
detector can be watched firing while every token stays the same).

Every run is judged by ``audit.RunAudit`` (``--no-audit`` skips it): the
report's ``audit`` block holds its findings and ``gate_ok``, and the
process exits 1 when the gate fails.  ``--metrics-port`` serves the live
endpoint (``audit.metrics.MetricsServer``: ``/metrics``,
``/metrics.json``, ``/events``, ``/timeline``, ``/requests/<rid>``,
``/healthz``) while the run goes on; port 0 picks a free port, reported
in the output, and ``--metrics-linger`` keeps it up after the drain.
``--trace-out FILE`` writes the per-request phase timelines as
Chrome-trace-event JSON (Perfetto, ``chrome://tracing``).
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.audit import (AuditContext, Evidence, EventLog,
                               MetricsServer, RunAudit, ServeMetrics, Tracer,
                               attribution, build_timelines,
                               chrome_trace_bytes)
from repro_torch.configs import reduced
from repro_torch.core.registry import resolve_arch
from repro_torch.models import build
from repro_torch.serve import (ClusterEngine, PagedServeEngine, Request,
                               SamplingParams, ServeEngine, resolve_device)


def serve(arch: str, *, n_requests: int = 8, slots: int = 4,
          max_len: int = 96, max_new: int = 16, seed: int = 0,
          engine: str = "paged", block_size: int = 8, chunk: int = 4,
          shared_prefix: int = 0, use_prefix_cache: bool = True,
          kernel: str = "paged", swap: bool = True, replicas: int = 1,
          routing: str = "affinity", audit: bool = True,
          metrics_port: int | None = None, metrics_linger: float = 0.0,
          trace_out: str | None = None, temperature: float = 0.0,
          top_k: int = 0, top_p: float = 1.0, sampling_seed: int = 0,
          device: str = "cuda") -> dict:
    if trace_out is not None and not audit:
        raise ValueError("--trace-out reconstructs timelines from the "
                         "audit tracer; drop --no-audit")
    dev = resolve_device(device)
    cfg = reduced(resolve_arch(arch))
    model = build(cfg)
    params = model.init_params(
        torch.Generator(device=dev).manual_seed(seed), dev)
    sampling = SamplingParams(temperature=temperature, top_k=top_k,
                              top_p=top_p, seed=sampling_seed)

    if engine == "paged" and cfg.family not in ("dense", "moe"):
        engine = "contiguous"   # no chunked path for stateful caches
    # cluster replicas are paged engines; anything that forces the
    # contiguous path also collapses the cluster to a single engine
    if engine != "paged":
        replicas = 1
    is_cluster = replicas > 1
    # a shared prefix shorter than one page cannot hit (only full blocks
    # register), so the workload is declared shared-prefix only when a hit
    # is possible
    run_audit = RunAudit(AuditContext(
        workload="serve", family=cfg.family, arch=cfg.name,
        shared_prefix=shared_prefix >= block_size)) if audit else None
    tracer = run_audit.tracer if run_audit else None
    replica_tracers = [Tracer() for _ in range(replicas)] if is_cluster else []

    # live observability, fed from the tracers' subscription hooks; a
    # cluster attaches one replica-labelled ServeMetrics per replica tracer
    # to the same registry, so one endpoint serves every replica's series
    metrics = server = None
    if metrics_port is not None:
        if tracer is None:
            raise ValueError("--metrics-port needs the audit tracer; "
                             "drop --no-audit")
        metrics = ServeMetrics()
        metrics.attach(tracer)
        for i, rt in enumerate(replica_tracers):
            ServeMetrics(metrics.registry,
                         labels={"replica": str(i)}).attach(rt)
        log = EventLog()
        tracer.subscribe(log.append)
        # the replica tracers carry the admit/prefill-done/finish events a
        # cluster's front tracer never sees
        for rt in replica_tracers:
            rt.subscribe(log.append)
        server = MetricsServer(metrics.registry, log)
        bound_port = server.serve(port=metrics_port)
    if is_cluster:
        eng = ClusterEngine(model, params, replicas=replicas, slots=slots,
                            max_len=max_len, block_size=block_size,
                            chunk=chunk, routing=routing,
                            use_prefix_cache=use_prefix_cache,
                            kernel=kernel, tracer=tracer,
                            replica_tracers=replica_tracers, device=dev)
    elif engine == "paged":
        eng = PagedServeEngine(model, params, slots=slots, max_len=max_len,
                               block_size=block_size, chunk=chunk,
                               use_prefix_cache=use_prefix_cache,
                               kernel=kernel, swap=swap, tracer=tracer,
                               device=dev)
    else:
        eng = ServeEngine(model, params, slots=slots, max_len=max_len,
                          tracer=tracer, device=dev)

    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, size=shared_prefix).tolist()
    reqs = [
        Request(rid=i,
                prompt=prefix + rng.integers(
                    0, cfg.vocab_size, size=rng.integers(4, 17)).tolist(),
                max_new=max_new, sampling=sampling)
        for i in range(n_requests)
    ]
    t0 = time.perf_counter()
    for req in reqs:
        eng.submit(req)
    done = eng.drain()
    wall = time.perf_counter() - t0

    ttfts = [r.t_first - r.t_submit for r in done if r.t_first]
    rep = eng.report()
    out = {
        "arch": cfg.name,
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "engine": rep["engine"],
        "sampling": sampling.describe(),
        "served": rep["served"],
        "decode_steps": rep["decode_steps"],
        "tokens_out": rep["tokens_out"],
        "mean_batch_occupancy": rep["mean_batch_occupancy"],
        "mean_ttft_s": round(float(np.mean(ttfts)), 4) if ttfts else None,
        "tokens_per_s": round(rep["tokens_out"] / max(wall, 1e-9), 1),
        "wall_s": round(wall, 2),
    }
    if is_cluster:
        out.update({k: rep[k] for k in
                    ("replicas", "routing", "routed", "routed_affinity",
                     "routed_spills", "shared_hit_rate", "prefix_hit_rate",
                     "preemptions", "kernel", "summary_rebuilds")})
    elif engine == "paged":
        out.update({k: rep[k] for k in
                    ("prefill_tokens", "cached_tokens", "prefix_hit_rate",
                     "page_peak_utilization", "preemptions", "kernel",
                     "swap", "swap_restore_rate",
                     "restored_tokens", "recompute_tokens")})
    if run_audit is not None:
        out["trace"] = tracer.summary()["counts"]
        lat = Evidence(tracer=tracer).request_latencies()
        if lat:
            ttft_ticks = [v["ttft_ticks"] for v in lat.values()]
            out["mean_ttft_ticks"] = round(float(np.mean(ttft_ticks)), 2)
            out["max_ttft_ticks"] = round(float(np.max(ttft_ticks)), 2)
        timelines = build_timelines(tracer, *replica_tracers)
        att = attribution(timelines)
        if att:
            out["attribution"] = {
                "p99_ttft_ticks": att["p99_ttft_ticks"],
                "dominant_phase": att["dominant_phase"],
                "p99_shares": {k: round(v, 3)
                               for k, v in att["p99_shares"].items()},
                "preempted_share": round(att["preempted_share"], 3),
            }
        if trace_out is not None:
            data = chrome_trace_bytes(timelines)
            Path(trace_out).write_bytes(data)
            out["trace_out"] = {"path": trace_out,
                                "requests": len(timelines),
                                "bytes": len(data)}
        diag = run_audit.finish(engine_report=eng.report(), source="serve")
        out["audit"] = {
            "findings": diag.findings,
            "worst": diag.worst,
            "gate_ok": diag.gate(),
            "trace": out["trace"],
        }
    if server is not None:
        metrics.observe_report(eng.report())
        out["metrics"] = {
            "port": bound_port,
            "endpoints": ["/metrics", "/metrics.json", "/events",
                          "/timeline", "/requests/<rid>", "/healthz"],
            "finished": metrics.finished.value,
            "p99_ttft_bucket": metrics.ttft.quantile(0.99),
        }
        if metrics_linger > 0:
            time.sleep(metrics_linger)
        server.close()
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--engine", choices=["paged", "contiguous"],
                    default="paged")
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="length of a prompt prefix shared by all requests")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples with counter-based "
                         "per-request noise (deterministic, replayable)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep only the k most likely tokens (0 = no limit)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus bound in (0, 1]")
    ap.add_argument("--sampling-seed", type=int, default=0)
    ap.add_argument("--kernel", choices=["paged", "gather"], default="paged",
                    help="paged engine's KV pathway: attend through the page "
                         "table, or the dense working-cache fallback (the "
                         "audit flags it: pathway-kernel)")
    ap.add_argument("--swap", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="host KV swap tier for preempted requests "
                         "(--no-swap recomputes on readmission; the streams "
                         "do not change)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="> 1 serves through a ClusterEngine: N paged "
                         "replicas behind prefix-affinity routing, one "
                         "metrics endpoint with replica-labelled series")
    ap.add_argument("--routing",
                    choices=["affinity", "round_robin", "random"],
                    default="affinity",
                    help="cluster routing policy (random misroutes on "
                         "purpose; the streams do not change)")
    ap.add_argument("--no-prefix-cache", dest="use_prefix_cache",
                    action="store_false",
                    help="disable prefix-KV reuse (the audit flags this on "
                         "shared-prefix workloads)")
    ap.add_argument("--no-audit", dest="audit", action="store_false",
                    help="skip runtime pathway auditing")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics, /metrics.json, /events and "
                         "/healthz on this port while the run is live "
                         "(0 = a free port, reported in the output)")
    ap.add_argument("--metrics-linger", type=float, default=0.0,
                    help="seconds to keep the metrics endpoint up after "
                         "the drain")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="write the per-request phase timelines as "
                         "Chrome-trace-event JSON; needs the audit tracer")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    res = serve(args.arch, n_requests=args.requests, slots=args.slots,
                max_len=args.max_len, max_new=args.max_new,
                engine=args.engine, block_size=args.block_size,
                chunk=args.chunk, shared_prefix=args.shared_prefix,
                use_prefix_cache=args.use_prefix_cache, kernel=args.kernel,
                swap=args.swap, replicas=args.replicas, routing=args.routing,
                audit=args.audit, metrics_port=args.metrics_port,
                metrics_linger=args.metrics_linger, trace_out=args.trace_out,
                temperature=args.temperature, top_k=args.top_k,
                top_p=args.top_p, sampling_seed=args.sampling_seed,
                device=args.device)
    print(json.dumps(res, indent=1))
    if res.get("audit") and not res["audit"]["gate_ok"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
