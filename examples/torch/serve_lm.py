"""Serve a small model through the unified request-lifecycle API: submit
requests with per-request SamplingParams, stream one request's tokens as
they decode, cancel another mid-flight, and drain the rest — all on the
paged continuous-batching engine (prefix cache, chunked prefill), its
attention through the paged kernel on a card.

    PYTHONPATH=src python examples/torch/serve_lm.py [--device cpu]

Mirrors ``examples/serve_lm.py``.  Runs on the GPU unless ``--device cpu``
is given; a CPU tensor takes the kernel's plain version.
"""
import argparse
import json

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, reduced
from repro_torch.kernels import ops
from repro_torch.launch.serve import serve
from repro_torch.models import build
from repro_torch.serve import (PagedServeEngine, Request, SamplingParams,
                               resolve_device)

if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    # the one-call driver (submit + drain under the hood)
    res = serve("deepseek-7b", n_requests=8, slots=4, max_len=96, max_new=12,
                shared_prefix=24, device=args.device)
    print(json.dumps(res, indent=1))
    assert res["served"] == 8
    assert res["engine"] == "paged" and res["kernel"] == "paged"
    assert res["cached_tokens"] > 0

    # the lifecycle API directly: streaming, sampling, cancellation
    cfg = reduced(ALL_ARCHS["deepseek-7b"])
    model = build(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dev)
    eng = PagedServeEngine(model, params, slots=2, max_len=64,
                           block_size=8, chunk=4, device=dev)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, size=12).tolist()
    sampled = SamplingParams(temperature=0.8, top_k=20, top_p=0.95, seed=42)

    stream = eng.submit(Request(rid=0, prompt=prompt, max_new=8,
                                sampling=sampled))
    doomed = eng.submit(Request(rid=1, prompt=list(prompt), max_new=8))
    tokens = []
    for tok in stream:           # pulls engine.step() as needed
        tokens.append(tok)
        if len(tokens) == 2:
            doomed.cancel()      # mid-flight: pages released immediately
    print("streamed:", tokens)
    assert len(tokens) == 8 and stream.finished
    assert doomed.cancelled and not doomed.finished
    eng.alloc.check()

    # counter-based sampling replays exactly: same (seed, rid) => same stream
    eng2 = PagedServeEngine(model, params, slots=2, max_len=64,
                            block_size=8, chunk=4, device=dev)
    replay = eng2.submit(Request(rid=0, prompt=list(prompt), max_new=8,
                                 sampling=sampled)).result()
    assert replay.out == tokens, (replay.out, tokens)
    print(f"LAUNCHES {json.dumps(ops.LAUNCHES)}")
    print("OK")
