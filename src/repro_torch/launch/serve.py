"""Serving CLI of the port: the paged engine over a smoke-scale model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \\
        --requests 8 --slots 4 [--temperature 0.8 --top-k 20 --top-p 0.95]

Mirrors ``repro.launch.serve`` for the flags this slice covers.  Like the
reference it serves ``reduced(arch)`` with seeded random weights (here
from a ``torch.Generator``).  Runs on the GPU unless ``--device cpu`` is
given, and fails when asked for a GPU that is not there.  ``--engine
contiguous`` serves through the oracle engine.  The metrics server,
cluster routing and trace export are not ported yet.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.audit.trace import Tracer
from repro_torch.configs import reduced, resolve_arch
from repro_torch.models import build
from repro_torch.serve import (PagedServeEngine, Request, SamplingParams,
                               ServeEngine, resolve_device)


def serve(arch: str, *, n_requests: int = 8, slots: int = 4,
          max_len: int = 96, max_new: int = 16, seed: int = 0,
          engine: str = "paged", block_size: int = 8, chunk: int = 4,
          shared_prefix: int = 0, temperature: float = 0.0, top_k: int = 0,
          top_p: float = 1.0, sampling_seed: int = 0,
          device: str = "cuda") -> dict:
    dev = resolve_device(device)
    cfg = reduced(resolve_arch(arch))
    model = build(cfg)
    params = model.init_params(
        torch.Generator(device=dev).manual_seed(seed), dev)
    sampling = SamplingParams(temperature=temperature, top_k=top_k,
                              top_p=top_p, seed=sampling_seed)
    tracer = Tracer()
    if engine == "paged":
        eng = PagedServeEngine(model, params, slots=slots, max_len=max_len,
                               block_size=block_size, chunk=chunk,
                               tracer=tracer, device=dev)
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
    ttft_ticks = [e.data["ttft_ticks"] for e in tracer.events("first-token")]
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
        "mean_ttft_ticks": (round(float(np.mean(ttft_ticks)), 2)
                            if ttft_ticks else None),
        "tokens_per_s": round(rep["tokens_out"] / max(wall, 1e-9), 1),
        "wall_s": round(wall, 2),
        "trace": tracer.summary()["counts"],
    }
    if engine == "paged":
        out.update({k: rep[k] for k in
                    ("prefill_tokens", "cached_tokens", "prefix_hit_rate",
                     "page_peak_utilization", "preemptions", "kernel",
                     "swap", "swap_restore_rate",
                     "restored_tokens", "recompute_tokens")})
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
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    res = serve(args.arch, n_requests=args.requests, slots=args.slots,
                max_len=args.max_len, max_new=args.max_new,
                engine=args.engine, block_size=args.block_size,
                chunk=args.chunk, shared_prefix=args.shared_prefix,
                temperature=args.temperature, top_k=args.top_k,
                top_p=args.top_p, sampling_seed=args.sampling_seed,
                device=args.device)
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
