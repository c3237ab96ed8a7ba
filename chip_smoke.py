#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero without printing a result:

1. build     — compile every CUDA kernel of the port from ``src/`` (nvcc,
               sm_90a, one process per source, all at once).
2. kernel    — each kernel against its plain PyTorch version on the card,
               over the CPU tests' geometries and the full-width ones of the
               dense and GQA archs (f32 tolerance 2e-5, bf16 2e-2).
3. reference — the paged decode step through the kernel against the same
               step on the CPU through the plain version, reduced
               deepseek-7b in f32 (logits within 1e-3).
4. serve     — ``PagedServeEngine`` serving deepseek-7b at full width and
               depth (6.9 B parameters, seeded random bf16 weights): 8
               requests sharing a 256-token prefix, one of them sampled.
               Launch counts are zeroed just before this run and read just
               after: the paged-attention kernel must have run once per
               layer per tick.  The same trace is then served again,
               untimed, to record its widest tick with every slot busy.
5. parity    — the kernel against its plain version on the page pool and
               page table that replay left behind (one layer).
6. timing    — kernel, plain version and ``scaled_dot_product_attention``
               (a yardstick the port never calls) at the serving run's
               decode shape, L2 flushed before each launch, beside the
               least time the card could take (its bound).
7. profile   — where a serving tick's time goes: host wall time per tick
               against device time per kernel (``torch.profiler``).

Then the ``kernels`` summary line, the card's name and power limit as
``nvidia-smi`` reports them, and last ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import ALL_ARCHS, reduced  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention_cuda, paged_attention_plain)
from repro_torch.models import build  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models.decode import decode_paged_chunk  # noqa: E402
from repro_torch.serve import (PagedServeEngine, Request,  # noqa: E402
                               SamplingParams)

ARCH = "deepseek-7b"
SLOTS, BLOCK, CHUNK, MAX_LEN = 4, 16, 16, 1024
N_REQUESTS, PREFIX, MAX_NEW = 8, 256, 32
SEED = 0
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# NVIDIA H100 SXM data sheet: HBM3 rate and dense peaks by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# (name, kv heads, group, head_dim) at full width
FULL_WIDTH = [("deepseek-7b", 32, 1, 128), ("phi3-medium-14b", 10, 4, 128),
              ("deepseek-coder-33b", 8, 7, 128),
              ("granite-moe-1b-a400m", 8, 2, 64), ("zamba2-2.7b", 32, 1, 80),
              ("phi3-mini-3.8b", 32, 1, 96)]
KERNEL_REPLACES = {"paged_attention": "src/repro/kernels/paged_attention.py:102"}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


# ------------------------------------------------------------------ cases


def paged_case(b, c, kv, g, hd, bs, n_pages, pos, n_new, dtype, seed,
               device, extra_blocks=4):
    """A paged-attention problem on ``device``: random pool, a random
    permutation page table (physical order never equals logical order)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    nb = b * n_pages + extra_blocks

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    perm = torch.randperm(nb, generator=gen, device=device)[:b * n_pages]
    return (randn(b, c, kv, g, hd), randn(nb, bs, kv, hd),
            randn(nb, bs, kv, hd),
            perm.reshape(b, n_pages).to(torch.int32).contiguous(),
            torch.tensor(pos, dtype=torch.int32, device=device),
            torch.tensor(n_new, dtype=torch.int32, device=device))


def compare(args, tol) -> float:
    """Kernel vs plain on every lane's valid rows; every row finite.
    Returns the max abs error over valid rows."""
    out = paged_attention_cuda(*args)
    ref = paged_attention_plain(*args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out.float()).all()), "non-finite kernel output")
    err = 0.0
    for lane, n in enumerate(args[5].tolist()):
        got, want = out[lane, :n].float(), ref[lane, :n].float()
        if n:
            err = max(err, float((got - want).abs().max()))
            check(torch.allclose(got, want, rtol=tol, atol=tol),
                  f"kernel != plain: lane {lane} n_new {n} "
                  f"q {tuple(args[0].shape)} {args[0].dtype}")
    return err


def lane_states(rng, b, c, bs, n_pages):
    """Ragged lanes at random positions: lane 0 a full chunk whose last row
    fills its page exactly, and with four lanes or more an idle lane and a
    decode lane; the rest random in [0, c]."""
    n_new = [int(n) for n in rng.integers(0, c + 1, size=b)]
    n_new[0] = c
    if b >= 4:
        n_new[1:3] = [0, 1]
    pos = []
    for i, n in enumerate(n_new):
        hi = n_pages * bs - max(n, 1)
        p = int(rng.integers(0, hi + 1))
        if i == 0:
            p = min(max(0, (p // bs) * bs + bs - n), hi)
        pos.append(p)
    return pos, n_new


# ----------------------------------------------------------------- phases


def phase_build() -> None:
    t0 = time.perf_counter()
    seconds = kbuild.build_all()
    ptxas = {}
    for name in kbuild.KERNELS:
        log = kbuild.library_path(name).with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[name] = [ln.strip() for ln in lines
                       if "registers" in ln or "spill" in ln][:8]
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 2),
          "per_kernel_s": {k: round(v, 2) for k, v in seconds.items()},
          "ptxas": ptxas})


def phase_kernel(dev) -> dict:
    rng = np.random.default_rng(SEED)
    n_cases, worst = 0, {}
    for dtype in (torch.float32, torch.bfloat16):
        err = 0.0
        # the CPU tests' sweep (b=2, hd=32, 4 pages)
        for kv in (1, 2):
            for g in (1, 2, 4):
                for bs in (4, 8, 16):
                    for c in (1, 2, 3, 4):
                        pos, n_new = lane_states(rng, 2, c, bs, 4)
                        args = paged_case(2, c, kv, g, 32, bs, 4, pos, n_new,
                                          dtype, n_cases, dev)
                        err = max(err, compare(args, TOL[dtype]))
                        n_cases += 1
        # edges: the largest head_dim and block the kernel takes, and a
        # block wider than a warp
        for kv, g, hd, bs, c in ((2, 3, 256, 64, 5), (4, 1, 96, 32, 3),
                                 (1, 8, 200, 48, 2)):
            pos, n_new = lane_states(rng, 4, c, bs, 6)
            args = paged_case(4, c, kv, g, hd, bs, 6, pos, n_new, dtype,
                              n_cases, dev)
            err = max(err, compare(args, TOL[dtype]))
            n_cases += 1
        # full width, serving geometry: 4 slots, 64 pages of 16
        for _, kv, g, hd in FULL_WIDTH:
            for c in (1, CHUNK):
                pos, n_new = lane_states(rng, SLOTS, c, BLOCK, MAX_LEN // BLOCK)
                args = paged_case(SLOTS, c, kv, g, hd, BLOCK, MAX_LEN // BLOCK,
                                  pos, n_new, dtype, n_cases, dev)
                err = max(err, compare(args, TOL[dtype]))
                n_cases += 1
        worst[str(dtype).replace("torch.", "")] = err
    emit({"phase": "kernel", "cases": n_cases, "max_abs_err": worst,
          "tolerance": {"float32": TOL[torch.float32],
                        "bfloat16": TOL[torch.bfloat16]},
          "full_width": [name for name, *_ in FULL_WIDTH]})
    return worst


def phase_reference(dev) -> None:
    """One model, two devices: the paged step through the CUDA kernel and
    through the plain version on the CPU, f32 weights and pools."""
    cfg = reduced(ALL_ARCHS[ARCH])
    model = build(cfg)
    params = P.tree_map(lambda t: t.float(), model.init_params(
        torch.Generator().manual_seed(SEED), "cpu"))
    spec = model.paged_cache_specs(16, 8)["paged"]["k"]
    pools = {"k": torch.zeros(spec.shape), "v": torch.zeros(spec.shape)}
    table = torch.tensor([[3, 7, 1, 0], [5, 2, 9, 0], [11, 4, 0, 0]],
                         dtype=torch.int32)
    rng = np.random.default_rng(SEED)
    steps = [([0, 0, 0], [4, 3, 0]), ([4, 3, 0], [1, 4, 2]),
             ([5, 7, 2], [1, 1, 4])]
    on = {"cpu": (params, {"paged": pools}),
          "gpu": (P.tree_map(lambda t: t.to(dev), params),
                  {"paged": P.tree_map(lambda t: t.to(dev), pools)})}
    err = 0.0
    for pos, n_new in steps:
        toks = rng.integers(0, cfg.vocab_size, size=(3, 4))
        logits = {}
        for where, (prm, cache) in on.items():
            d = dev if where == "gpu" else torch.device("cpu")
            logits[where] = decode_paged_chunk(
                cfg, prm, cache, torch.tensor(toks, device=d),
                torch.tensor(pos, dtype=torch.int32, device=d),
                torch.tensor(n_new, dtype=torch.int32, device=d),
                table.to(d)).cpu()
        err = max(err, float((logits["gpu"] - logits["cpu"]).abs().max()))
    check(err < 1e-3, f"GPU paged step vs CPU plain step: max |dlogit| {err}")
    emit({"phase": "reference", "arch": cfg.name, "dtype": "float32",
          "steps": len(steps), "max_abs_logit_err": err, "tolerance": 1e-3})


class RecordingModel:
    """Wraps the model's paged step to keep the arguments of the widest
    tick with every slot busy: the parity and timing phases replay that
    tick's real page table on the pool the run leaves behind.  Each call
    reads its arguments back from the device, so it wraps an untimed
    replay of the serving run, never the timed one."""

    def __init__(self, model):
        self.model = model
        self.cfg = model.cfg
        self.best = None

    def __getattr__(self, name):
        return getattr(self.model, name)

    def _record(self, pos, n_new, page_table):
        if int((n_new > 0).sum()) == SLOTS:
            keys = int(pos.sum())
            if self.best is None or keys >= self.best[0]:
                self.best = (keys, pos.clone(), n_new.clone(),
                             page_table.clone())

    def decode_paged_greedy_chunk(self, params, cache, tokens, pos, n_new,
                                  page_table):
        self._record(pos, n_new, page_table)
        return self.model.decode_paged_greedy_chunk(params, cache, tokens,
                                                    pos, n_new, page_table)

    def decode_paged_sample_chunk(self, params, cache, tokens, pos, n_new,
                                  page_table, lane):
        self._record(pos, n_new, page_table)
        return self.model.decode_paged_sample_chunk(
            params, cache, tokens, pos, n_new, page_table, lane)


def serve_requests(cfg) -> list:
    """The serving trace, made anew from the seed on every call."""
    rng = np.random.default_rng(SEED)
    prefix = rng.integers(0, cfg.vocab_size, size=PREFIX).tolist()
    sampled = SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=1)
    return [Request(rid=i, max_new=MAX_NEW,
                    prompt=prefix + rng.integers(
                        0, cfg.vocab_size,
                        size=int(rng.integers(16, 257))).tolist(),
                    sampling=sampled if i == 3 else None)
            for i in range(N_REQUESTS)]


def phase_serve(dev):
    cfg = ALL_ARCHS[ARCH]
    t0 = time.perf_counter()
    model = build(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED),
                               dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in P.leaves(params))

    # warm-up (cuBLAS handles, allocator) on a small engine of its own
    warm = PagedServeEngine(model, params, slots=2, max_len=64,
                            block_size=BLOCK, chunk=CHUNK, num_blocks=16,
                            device=dev)
    warm.run([Request(rid=0, prompt=list(range(20)), max_new=3)])
    del warm

    reqs = serve_requests(cfg)
    eng = PagedServeEngine(model, params, slots=SLOTS, max_len=MAX_LEN,
                           block_size=BLOCK, chunk=CHUNK, device=dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)

    rep = eng.report()
    check(rep["served"] == N_REQUESTS, f"served {rep['served']}")
    check(rep["prefix_hit_rate"] > 0, "no prefix-cache hits")
    check(launches["paged_attention"] == rep["decode_steps"] * cfg.n_layers,
          f"paged_attention launched {launches['paged_attention']} times, "
          f"expected decode_steps x layers = "
          f"{rep['decode_steps']} x {cfg.n_layers}")
    eng.alloc.check()
    eng.host.check()
    for r in done:
        check(len(r.out) == MAX_NEW, f"request {r.rid}: {len(r.out)} tokens")
        check(all(0 <= t < cfg.padded_vocab for t in r.out),
              f"request {r.rid}: token outside the vocab")
    streams = {r.rid: r.out for r in done}
    del eng

    # the same trace again, untimed, through the recording wrapper: its
    # pool and widest busy tick feed the parity and timing phases
    recorder = RecordingModel(model)
    replay = PagedServeEngine(recorder, params, slots=SLOTS, max_len=MAX_LEN,
                              block_size=BLOCK, chunk=CHUNK, device=dev)
    replayed = {r.rid: r.out for r in replay.run(serve_requests(cfg))}
    replay.alloc.check()
    check(recorder.best is not None, "no tick with every slot busy")
    emit({"phase": "serve", "arch": cfg.name, "params": n_params,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "init_s": round(init_s, 2), "wall_s": round(wall, 3),
          "decode_steps": rep["decode_steps"],
          "ms_per_tick": round(1e3 * wall / rep["decode_steps"], 3),
          "tokens_out_per_s": round(rep["tokens_out"] / wall, 2),
          "tokens_processed_per_s": round(
              (rep["tokens_out"] + rep["prefill_tokens"]) / wall, 2),
          "launches": launches,
          "peak_mem_gb": round(torch.cuda.max_memory_allocated(dev) / 1e9, 2),
          "report": rep,
          "replay_streams_equal": replayed == streams,
          "first_tokens": {rid: out[:4] for rid, out in streams.items()}})
    return model, params, replay, recorder.best, launches


def phase_profile(model, params, dev, warm=30, ticks=10) -> None:
    """Where a serving tick's time goes: the serve phase's traffic on a
    fresh engine, ``ticks`` ticks timed on the host clock, then the next
    ``ticks`` under ``torch.profiler`` for device time by kernel.  The
    device's busy share is the profiled device time per tick over the
    unprofiled wall time per tick (the profiler inflates wall time)."""
    from torch.profiler import ProfilerActivity, profile
    cfg = model.cfg
    rng = np.random.default_rng(SEED)
    prefix = rng.integers(0, cfg.vocab_size, size=PREFIX).tolist()
    eng = PagedServeEngine(model, params, slots=SLOTS, max_len=MAX_LEN,
                           block_size=BLOCK, chunk=CHUNK, device=dev)
    for i in range(N_REQUESTS):
        eng.submit(Request(rid=i, max_new=MAX_NEW, prompt=prefix + rng.integers(
            0, cfg.vocab_size, size=int(rng.integers(16, 257))).tolist()))
    for _ in range(warm):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / ticks * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
    by_kernel = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + us
    device_ms = sum(by_kernel.values()) / ticks / 1e3
    check(device_ms > 0, "the profiler saw no device time")
    paged = sum(v for k, v in by_kernel.items() if "paged_attention" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "profile", "ticks": ticks, "after_ticks": warm,
          "wall_ms_per_tick": wall_ms, "device_ms_per_tick": device_ms,
          "device_busy_share": device_ms / wall_ms,
          "paged_attention_ms_per_tick": paged / ticks / 1e3,
          "paged_attention_share_of_device": paged / 1e3 / ticks / device_ms,
          "weights_read_bound_ms_per_tick":
              2 * P.count(model.param_specs()) / HBM_BYTES_PER_S * 1e3,
          "top_kernels_ms_per_tick": {k[:60]: v / ticks / 1e3
                                      for k, v in top}})


def bound_ms(q, page_table, pos, n_new, k_pool):
    """The least time for the call, from this run's data: the bytes the
    function must move (valid K/V rows once, valid q rows once, the whole
    output once, the table) over HBM rate, or its flops over the peak of
    its operand type, whichever is larger."""
    b, c, kv, g, hd = q.shape
    item = q.element_size()
    bytes_, flops = 0, 0
    for p, n in zip(pos.tolist(), n_new.tolist()):
        rows = max(n, 1)
        keys = p + rows
        bytes_ += 2 * keys * kv * hd * item + rows * kv * g * hd * item
        flops += sum(4 * hd * kv * g * (p + i + 1) for i in range(rows))
    bytes_ += q.numel() * item + page_table.numel() * 4 + 2 * b * 4
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS_PER_S[q.dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            bytes_, flops)


def time_cold(fn, dev, n=50) -> float:
    """Median device ms of ``fn`` over ``n`` calls, each after the L2 cache
    (50 MB) was flushed, as the serving loop finds it after the other
    layers ran.  A spin kernel (about 2 ms) holds the stream while the host
    enqueues ``fn``, so the events bracket device work only, not the
    host's time to issue it."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(4_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sdpa_args(q, k_pool, v_pool, page_table, pos):
    """Dense K/V gathered through the page table and the same causal chunk
    mask, laid out for ``scaled_dot_product_attention`` with GQA."""
    b, c, kv, g, hd = q.shape
    n_pages, bs = page_table.shape[1], k_pool.shape[1]
    s = n_pages * bs
    k = k_pool[page_table.long()].reshape(b, s, kv, hd).transpose(1, 2)
    v = v_pool[page_table.long()].reshape(b, s, kv, hd).transpose(1, 2)
    qs = q.reshape(b, c, kv * g, hd).transpose(1, 2)
    rows = pos[:, None].long() + torch.arange(c, device=q.device)[None]
    mask = (torch.arange(s, device=q.device)[None, None, :]
            <= rows[:, :, None])[:, None]
    return qs.contiguous(), k.contiguous(), v.contiguous(), mask


def phase_parity_and_timing(eng, best, dev):
    _, pos, n_new, page_table = best
    cfg = eng.model.cfg
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    g = cfg.n_heads // kv
    k_pool, v_pool = eng.view.k[0], eng.view.v[0]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn((SLOTS, CHUNK, kv, g, hd), generator=gen,
                    device=dev).to(k_pool.dtype)
    args = (q, k_pool, v_pool, page_table, pos, n_new)
    bs = k_pool.shape[1]
    live = [set(page_table[i, :(p + max(n, 1) + bs - 1) // bs].tolist())
            for i, (p, n) in enumerate(zip(pos.tolist(), n_new.tolist()))]
    shared = len(set.intersection(*live))
    err = compare(args, TOL[q.dtype])
    emit({"phase": "parity", "layer": 0, "pos": pos.tolist(),
          "n_new": n_new.tolist(), "pages_shared_by_all_slots": shared,
          "max_abs_err": err, "tolerance": TOL[q.dtype]})

    from torch.nn.functional import scaled_dot_product_attention as sdpa
    qs, ks, vs, mask = sdpa_args(*args[:5])
    lib_out = sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True)
    ref = paged_attention_plain(*args)
    lib_err = max(
        float((lib_out[i].transpose(0, 1).reshape(CHUNK, kv, g, hd)[:n]
               .float() - ref[i, :n].float()).abs().max())
        for i, n in enumerate(n_new.tolist()) if n)
    bound, bound_by, bytes_, flops = bound_ms(q, page_table, pos, n_new,
                                              k_pool)
    t_kernel = time_cold(lambda: paged_attention_cuda(*args), dev)
    t_plain = time_cold(lambda: paged_attention_plain(*args), dev)
    t_lib = time_cold(lambda: sdpa(qs, ks, vs, attn_mask=mask,
                                   enable_gqa=True), dev)
    timing = {"phase": "timing", "shape": list(q.shape),
              "dtype": str(q.dtype).replace("torch.", ""),
              "pos": pos.tolist(), "n_new": n_new.tolist(),
              "ms": t_kernel, "plain_ms": t_plain, "library_ms": t_lib,
              "library": "scaled_dot_product_attention(enable_gqa) on K/V "
                         "pre-gathered through the page table",
              "library_max_abs_err": lib_err,
              "bound_ms": bound, "bound_by": bound_by, "bytes": bytes_,
              "flops": flops, "bound_share": bound / t_kernel,
              "gpu": nvidia_smi()}
    emit(timing)
    return err, timing


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's chip check needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build()
    phase_kernel(dev)
    phase_reference(dev)
    model, params, replay, best, launches = phase_serve(dev)
    err, timing = phase_parity_and_timing(replay, best, dev)
    del replay
    phase_profile(model, params, dev)
    emit({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": KERNEL_REPLACES["paged_attention"],
        "launches": launches["paged_attention"], "max_abs_err": err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"]}],
        "seconds": round(time.perf_counter() - t0, 1)})
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
