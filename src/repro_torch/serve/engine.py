"""Serving engines on PyTorch: the paged engine and its contiguous oracle.

Ports ``repro.serve.engine``.  Both engines implement the ``serve.api.
Engine`` protocol — ``submit / step / drain / cancel / report`` — and
report the reference's keys, so the same callers and audit rules read
either package's engines.

``PagedServeEngine`` is the production path: a refcounted block allocator
and hash-chained prefix cache (``serve.paging``) so overlapping prompts
reuse KV pages, chunked prefill so a long prompt consumes ``chunk``
tokens per step in the same batched call that advances decoding lanes by
one, and a priority scheduler with preemption on OOM.  Preempted work
parks its written KV pages on a host swap tier and readmission swaps them
back in (recompute-on-readmit is the costed fallback).  KV lives in a
page pool on the device and is written and attended through the per-slot
page table (``decode_paged_chunk`` → ``kernels.ops.paged_attention``: the
CUDA kernel on a card).  ``kernel="gather"`` is the reference's dense
fallback: KV lives in a per-slot working cache (``decode_chunk``, plain
torch ops), registered prefix blocks are copied out to a host ``KVPool``
and a prefix hit is gathered back into the new slot's rows at admission.
``compare_engines`` holds the paged engine, on either pathway, to the
contiguous oracle token for token (``core.verify.DualEnvHarness``).

``ServeEngine`` is the contiguous engine, one decode step per token over
per-slot caches; it is the paged engine's oracle, and the engine of the
ssm and hybrid families, whose conv and SSM state has no paged form.  As
in the reference, its serial prefill steps every slot for each prompt
token and never resets a slot's state at admission: attention rows are
rewritten idempotently, but each extra step advances the other lanes'
conv and SSM state (ROADMAP caveat g), so an ssm stream depends on the
admissions around it.

The engines run on ``device`` ("cuda" unless the caller asks for "cpu")
and raise when it is not there.  Each tick hands the device freshly
built tensors: no host buffer that is mutated before the tick's result is
read is ever shared with it (the reference's contiguous engine races on
exactly that).  Steps run eagerly, so ``compiles`` is always 0.
"""
from __future__ import annotations

import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.audit.trace import NULL_TRACER, Tracer
from repro_torch.models import params as P
from repro_torch.models.model import Model
from repro_torch.serve.api import (GREEDY, LaneState, RequestHandle,
                                   SamplingParams, run_requests)
from repro_torch.serve.paging import (BlockAllocator, DevicePageView,
                                      HostSwapPool, KVPool, PrefixCache,
                                      chain_hashes, host_dtype, pages_for,
                                      to_device, to_host)
from repro_torch.serve.scheduler import (DONE, PREEMPTED, RUNNING, WAITING,
                                         Plan, SchedEntry, Scheduler,
                                         SwapCostModel)

# quantile feeds (ttft_ticks) keep at most this many samples: a bounded
# ring, not an unbounded per-request append, so a long-lived serving
# process holds steady-state memory
LATENCY_RING = 4096


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for and
    absent (the CPU runs only when the caller names it)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _check_params_on(params: Any, device: torch.device) -> None:
    for t in P.leaves(params):
        if t.device != device:
            raise ValueError(f"parameters live on {t.device}, the engine "
                             f"runs on {device}")


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 32
    eos_id: int = -1            # -1: never stops early
    priority: int = 0           # higher preempts lower on OOM (paged path)
    sampling: SamplingParams | None = None   # None => greedy
    out: list[int] = field(default_factory=list)
    finished: bool = False
    cancelled: bool = False
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


def _validate(req: Request) -> None:
    """Static request validation shared by both engines' ``submit``."""
    if not req.prompt:
        raise ValueError(f"request {req.rid}: empty prompt (decoding "
                         f"needs at least one token of context)")
    if not -2**31 <= req.rid < 2**31:
        # the rid rides an int32 lane array into the step
        raise ValueError(f"request id {req.rid} does not fit int32")


def _validate_fit(req: Request, max_len: int) -> None:
    """Reject a generation budget the slot geometry cannot hold (both
    engines clamp the prompt to ``prompt[-(max_len - max_new):]``)."""
    if req.max_new < 1:
        raise ValueError(
            f"request {req.rid}: max_new={req.max_new} must be >= 1")
    if req.max_new >= max_len:
        raise ValueError(
            f"request {req.rid}: max_new={req.max_new} must be < "
            f"max_len={max_len} (the prompt is clamped to max_len - "
            f"max_new tokens of context; no context would remain)")


def _weak(method: Callable) -> Callable:
    """``method`` called through a weak reference to its object: the parts
    an engine hands its hooks to hold no strong reference back to it, so a
    dropped engine (and the model memory it holds) is freed at once, not
    at the collector's next pass."""
    ref = weakref.WeakMethod(method)
    return lambda *args: ref()(*args)


def _samples(req: Request) -> bool:
    return not (req.sampling or GREEDY).greedy


@dataclass
class EngineStats:
    served: int = 0
    cancelled: int = 0
    decode_steps: int = 0
    tokens_out: int = 0
    # bounded occupancy accumulator (running sum + tick count)
    occupancy_sum: int = 0
    occupancy_ticks: int = 0

    def observe_occupancy(self, lanes: int) -> None:
        self.occupancy_sum += lanes
        self.occupancy_ticks += 1

    @property
    def mean_occupancy(self) -> float:
        return (self.occupancy_sum / self.occupancy_ticks
                if self.occupancy_ticks else 0.0)


class _DeviceArgs:
    """Fresh device tensors from host arrays, one set per call."""

    def __init__(self, device: torch.device):
        self.device = device

    def __call__(self, arr: np.ndarray) -> torch.Tensor:
        return torch.tensor(arr, device=self.device)

    def lanes(self, lane: LaneState) -> dict[str, torch.Tensor]:
        return {k: self(v) for k, v in lane.as_args().items()}


class ServeEngine:
    """Contiguous slot caches with serial per-token prefill at admission:
    the paged engine's oracle."""

    def __init__(self, model: Model, params: Any, *, slots: int = 4,
                 max_len: int = 256, tracer: Tracer | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        _check_params_on(params, self.device)
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.cache = model.zero_cache(slots, max_len, self.device)
        self.pos = np.zeros((slots,), np.int32)       # next write position
        self.active: dict[int, Request] = {}          # slot -> request
        self.pending: list[tuple[float, Request]] = []  # (arrival, req) FCFS
        self.now = 0.0                                # step-counter clock
        self.lane = LaneState(slots)
        self.stats = EngineStats()
        self.trace = tracer or NULL_TRACER
        self._last_token = np.zeros((slots, 1), np.int32)
        self._args = _DeviceArgs(self.device)
        self.trace.emit("engine-init", engine="contiguous",
                        family=model.cfg.family, arch=model.cfg.name,
                        slots=slots, max_len=max_len)

    def _decode(self, sample: bool) -> np.ndarray:
        """One batched decode step over all slots (greedy or sampled)."""
        a = self._args
        if sample:
            toks = self.model.decode_sample_step(
                self.params, self.cache, a(self._last_token), a(self.pos),
                a.lanes(self.lane))
        else:
            toks = self.model.decode_greedy_step(
                self.params, self.cache, a(self._last_token), a(self.pos))
        return toks.cpu().numpy()

    # ------------------------------------------------------------ intake
    def submit(self, req: Request, *, arrival: float | None = None
               ) -> RequestHandle:
        _validate(req)
        _validate_fit(req, self.max_len)
        arrival = self.now if arrival is None else arrival
        req.t_submit = req.t_submit or time.perf_counter()
        self.pending.append((arrival, req))
        self.trace.emit("submit", rid=req.rid, tick=self.now,
                        arrival=arrival, prompt_tokens=len(req.prompt),
                        max_new=req.max_new,
                        sampling=(req.sampling or GREEDY).describe())
        return RequestHandle(self, req)

    def has_work(self) -> bool:
        return bool(self.pending or self.active)

    def _free_slots(self) -> list[int]:
        return [s for s in range(self.slots) if s not in self.active]

    def _admit(self, req: Request, slot: int, arrival: float) -> None:
        """Prefill the prompt into this slot serially, one token per step
        (other lanes' rows are rewritten idempotently and their tokens
        discarded; only the last step's token is read, so only it runs
        the sampled variant)."""
        tokens = req.prompt[-(self.max_len - req.max_new):]
        self.lane.set(slot, req)     # step=0: the first output token's key
        for i, tok in enumerate(tokens):
            self._last_token[slot, 0] = tok
            self.pos[slot] = i
            toks = self._decode(_samples(req) and i == len(tokens) - 1)
        self.pos[slot] = len(tokens)
        nxt = int(toks[slot])
        req.out.append(nxt)
        req.t_first = time.perf_counter()
        self._last_token[slot, 0] = nxt
        self.active[slot] = req
        self.trace.emit("admit", rid=req.rid, slot=slot, tick=self.now,
                        prompt_tokens=len(tokens), cached_tokens=0)
        self.trace.emit("prefill-done", rid=req.rid, tick=self.now,
                        slot=slot, consumed=len(tokens))
        self.trace.emit("first-token", rid=req.rid, tick=self.now,
                        ttft_ticks=self.now - arrival)

    def _retire(self, slot: int) -> Request:
        req = self.active.pop(slot)
        req.finished = True
        req.t_done = time.perf_counter()
        self.lane.clear(slot)
        self.trace.emit("finish", rid=req.rid, slot=slot, tick=self.now,
                        tokens_out=len(req.out))
        self.stats.served += 1
        return req

    # -------------------------------------------------------------- step
    def step(self) -> list[Request]:
        """One engine tick: admit ready pending requests (strict FCFS over
        ready ones) into free slots, then one batched decode call."""
        self.now += 1.0
        done: list[Request] = []
        i = 0
        while i < len(self.pending) and self._free_slots():
            arrival, req = self.pending[i]
            if arrival > self.now:
                i += 1
                continue
            self.pending.pop(i)
            slot = self._free_slots()[0]
            self._admit(req, slot, arrival)
            tok = req.out[-1]
            if (tok == req.eos_id or len(req.out) >= req.max_new
                    or self.pos[slot] >= self.max_len - 1):
                done.append(self._retire(slot))

        if not self.active:
            return done
        sample = any(_samples(r) for r in self.active.values())
        if sample:
            for slot, req in self.active.items():
                self.lane.set(slot, req)
        nxt = self._decode(sample)
        self.stats.decode_steps += 1
        self.stats.observe_occupancy(len(self.active))
        self.trace.emit("step", step_kind="decode", lanes=len(self.active))

        finished = []
        for slot, req in self.active.items():
            tok = int(nxt[slot])
            req.out.append(tok)
            self.stats.tokens_out += 1
            self.pos[slot] += 1
            self._last_token[slot, 0] = tok
            if (tok == req.eos_id or len(req.out) >= req.max_new
                    or self.pos[slot] >= self.max_len - 1):
                finished.append(slot)
        return done + [self._retire(slot) for slot in finished]

    def drain(self) -> list[Request]:
        done: list[Request] = []
        while self.has_work():
            done.extend(self.step())
        return done

    # ------------------------------------------------------------ cancel
    def cancel(self, handle: RequestHandle) -> bool:
        req = handle.req
        if req.finished or req.cancelled:
            return False
        phase = None
        for i, (_, r) in enumerate(self.pending):
            if r is req:
                self.pending.pop(i)
                phase = "waiting"
                break
        if phase is None:
            for slot, r in list(self.active.items()):
                if r is req:
                    self.active.pop(slot)
                    self.lane.clear(slot)
                    phase = "decode"     # contiguous has no mid-prefill gap
                    break
        if phase is None:
            return False
        req.cancelled = True
        req.t_done = time.perf_counter()
        self.stats.cancelled += 1
        self.trace.emit("cancel", rid=req.rid, phase=phase, tick=self.now,
                        released_pages=0)
        return True

    # ---------------------------------------------------------- run shim
    def run(self, requests: list[Request],
            arrivals: list[float] | None = None) -> list[Request]:
        return run_requests(self, requests, arrivals)

    # -------------------------------------------------------------- report
    def report(self) -> dict:
        return {
            "engine": "contiguous",
            "served": self.stats.served,
            "cancelled": self.stats.cancelled,
            "decode_steps": self.stats.decode_steps,
            "tokens_out": self.stats.tokens_out,
            "mean_batch_occupancy": round(self.stats.mean_occupancy, 2),
            "compiles": 0,      # eager PyTorch compiles nothing
        }


# ================================================================== paged


@dataclass
class PagedStats:
    prefill_tokens: int = 0      # prompt tokens actually computed
    cached_tokens: int = 0       # prompt tokens served from the prefix cache
    admit_retries: int = 0       # admissions bounced by an intra-tick race
    # host swap tier accounting: every readmission of previously-computed
    # rows either restores them from the tier (swap-in) or re-prefills
    # them (recompute)
    restored_tokens: int = 0     # KV rows swapped back in on readmission
    recompute_tokens: int = 0    # previously-computed rows re-prefilled
    swap_outs: int = 0           # preemptions that parked pages on host
    swap_ins: int = 0            # readmissions served from the host tier

    @property
    def prefix_hit_rate(self) -> float:
        total = self.prefill_tokens + self.cached_tokens
        return self.cached_tokens / total if total else 0.0

    @property
    def swap_restore_rate(self) -> float:
        total = self.restored_tokens + self.recompute_tokens
        return self.restored_tokens / total if total else 0.0


@dataclass
class _SwapRecord:
    """A preempted request's host-parked state: the KV rows it had
    written, page-granular, plus how many rows they cover.  ``host_ids``
    is empty when the tier was full or swap is disabled — the record
    still rides along so recompute on readmission is attributed."""
    consumed: int
    host_ids: list[int] = field(default_factory=list)


@dataclass
class _Slot:
    entry: SchedEntry
    req: Request
    feed: list[int]              # prompt (clamped) + generated-so-far
    hashes: list[int]            # chain hashes over full blocks of feed
    pending: list[int]           # feed tokens not yet computed
    consumed: int                # KV rows written (= next write position)
    shared: list[int]            # matched prefix pages (refs held)
    private: list[int]           # pages allocated for this request
    registered: int              # full feed blocks registered / matched
    next_input: int = -1         # decode-phase input token
    table: list[int] = field(default_factory=list)  # logical block -> page
                                 # (paged pathway: shared then private, in
                                 # feed order; block i's KV lives wholly in
                                 # page table[i]; empty on the gather one)
    reg_cursor: int = 0          # next private page usable for registration
                                 # (gather pathway)


class PagedServeEngine:
    """Paged-KV continuous batching: prefix reuse + chunked prefill.

    Every step is one fixed-shape chunked call: prefill lanes feed up to
    ``chunk`` prompt tokens, decode lanes feed their last sampled token,
    idle lanes feed nothing (n_new=0).

    ``kernel`` picks the KV pathway.  ``"paged"`` (the default): KV lives
    in the shared page pool (``serve.paging.DevicePageView``) and the step
    writes and attends it through the page table; prefix hits are pure
    metadata (the matched pages appear in the new slot's table row, zero
    copies) and registration publishes the page a block already lives in.
    ``"gather"``: KV lives in a dense per-slot working cache on the device
    and the step is ``decode_chunk``; registration copies a block's rows
    out to a private page of the host ``KVPool``, and admission gathers a
    prefix hit's pages back into the slot's rows.  Both pathways give the
    same streams.

    Deterministic by construction: the scheduler runs on the engine's
    synthetic tick clock, so a trace (prompts, priorities, arrivals)
    replays to the same schedule and the same token streams — greedy and
    sampled alike, because sampled tokens key on (seed, rid, step), not
    on slots or schedule.

    ``admit_every`` batches scheduler invocations to every N-th tick
    (N=1, the default, schedules every tick); values > 1 model a
    misconfigured admission interval (same streams, inflated TTFT).
    """

    def __init__(self, model: Model, params: Any, *, slots: int = 4,
                 max_len: int = 256, block_size: int = 16,
                 num_blocks: int | None = None, chunk: int = 8,
                 tick_dt: float = 1.0, use_prefix_cache: bool = True,
                 admit_every: int = 1, kernel: str = "paged",
                 preemption: bool = True, swap: bool = True,
                 host_blocks: int | None = None,
                 swap_cost: SwapCostModel | None = None,
                 tracer: Tracer | None = None,
                 device: str | torch.device = "cuda"):
        if model.cfg.family not in ("dense", "moe"):
            raise ValueError(
                f"the paged engine needs an attention cache (dense or moe); "
                f"{model.cfg.family!r} serves through ServeEngine")
        if admit_every < 1:
            raise ValueError(f"admit_every must be >= 1, got {admit_every}")
        if kernel not in ("paged", "gather"):
            raise ValueError(
                f"kernel must be 'paged' (attend through the page table) "
                f"or 'gather' (dense working-cache fallback), got {kernel!r}")
        self.device = resolve_device(device)
        _check_params_on(params, self.device)
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.chunk = chunk
        self.kernel = kernel
        if num_blocks is None:
            num_blocks = 2 * slots * pages_for(max_len, block_size)
        self.alloc = BlockAllocator(num_blocks, block_size)
        self.prefix = PrefixCache(self.alloc)
        self.prefix_enabled = use_prefix_cache
        # host swap tier: preempted requests park written pages here and
        # readmission swaps them back in instead of re-prefilling; cold
        # prefix pages evicted under pressure spill to the same tier.
        self.swap_enabled = swap
        if host_blocks is None:
            host_blocks = 2 * num_blocks
        self.host = HostSwapPool(host_blocks, block_size)
        self.swap_cost = swap_cost or SwapCostModel()
        self._swap_records: dict[int, _SwapRecord] = {}   # entry.seq -> rec
        if kernel == "paged":
            # KV storage IS the device page pool; its geometry comes from
            # the declarative spec the paged step is written against
            spec = model.paged_cache_specs(num_blocks,
                                           block_size)["paged"]["k"]
            layers, _, _, n_kv, hd = spec.shape
            self.pool = None
            self.view = DevicePageView(
                num_blocks, block_size, layers, n_kv, hd, spec.dtype,
                slots=slots, max_pages=pages_for(max_len, block_size),
                device=self.device)
            self.cache = self.view.cache()
        else:
            # a dense working cache per slot, and registered prefix pages
            # in host memory
            spec = model.cache_specs(slots, max_len)["self"]["k"]
            layers, _, _, n_kv, hd = spec.shape
            self.pool = KVPool(num_blocks, block_size, layers, n_kv, hd,
                               host_dtype(spec.dtype))
            self.view = None
            self.cache = model.zero_cache(slots, max_len, self.device)
        if swap and use_prefix_cache and kernel == "paged":
            # cold-prefix spill rides the host tier on the paged pathway
            # only: gather-mode registered pages already live in the host
            # KVPool, spilling them would copy host to host
            self.prefix.attach_spill(
                spill_out=_weak(self._spill_page),
                page_in=_weak(self._page_in),
                drop=self.host.decref, capacity=host_blocks)
        self.now = 0.0
        self.tick_dt = tick_dt
        self.admit_every = admit_every
        self._ticks = 0
        self.lane = LaneState(slots)
        self.trace = tracer or NULL_TRACER
        self.sched = Scheduler(slots=slots, clock=_weak(self._clock),
                               tracer=self.trace, preemption=preemption)
        self.active: dict[int, _Slot] = {}
        self.stats = EngineStats()
        self.pstats = PagedStats()
        # first-token latency, tick clock — bounded ring (quantile feed)
        self.ttft_ticks: deque[float] = deque(maxlen=LATENCY_RING)
        self._args = _DeviceArgs(self.device)
        self.trace.emit("engine-init", engine="paged",
                        family=model.cfg.family, arch=model.cfg.name,
                        slots=slots, max_len=max_len, block_size=block_size,
                        chunk=chunk, pages=num_blocks,
                        prefix_cache=use_prefix_cache,
                        admit_every=admit_every, kernel=kernel,
                        preemption=preemption, swap=swap,
                        host_pages=host_blocks)

    def _clock(self) -> float:
        return self.now

    # ------------------------------------------------------------ intake
    def submit(self, req: Request, *, arrival: float | None = None
               ) -> RequestHandle:
        # reject statically-unplaceable requests here, where only the bad
        # request fails — once queued, it would starve everything behind
        # it (strict head-of-line) without ever becoming admissible
        _validate(req)
        _validate_fit(req, self.max_len)
        worst = pages_for(len(self._feed_of(req)) + req.max_new,
                          self.alloc.block_size)
        if worst > self.alloc.num_blocks:
            raise ValueError(
                f"request {req.rid} needs {worst} pages even fully "
                f"recomputed; pool has {self.alloc.num_blocks}")
        arrival = self.now if arrival is None else arrival
        req.t_submit = req.t_submit or time.perf_counter()
        entry = self.sched.submit(req, priority=req.priority, arrival=arrival)
        self.trace.emit("submit", rid=req.rid, tick=self.now,
                        arrival=arrival, prompt_tokens=len(req.prompt),
                        max_new=req.max_new,
                        sampling=(req.sampling or GREEDY).describe())
        return RequestHandle(self, req, entry)

    def has_work(self) -> bool:
        return self.sched.has_work()

    def _free_slots(self) -> list[int]:
        return [s for s in range(self.slots) if s not in self.active]

    def _feed_of(self, req: Request) -> list[int]:
        prompt = req.prompt[-(self.max_len - req.max_new):]
        return list(prompt) + list(req.out)

    def _cost(self, entry: SchedEntry) -> int:
        """Net new pages if admitted now (prefix hits are shared, free).
        A preempted entry the cost model restores by swap-in costs its
        full page count (every page comes back private)."""
        req = entry.req
        feed = self._feed_of(req)
        total = pages_for(len(feed) + req.max_new - len(req.out),
                          self.alloc.block_size)
        if self._restorable(entry) is not None:
            return total
        matched = (self.prefix.peek(feed, max_tokens=len(feed) - 1)
                   if self.prefix_enabled else 0)
        return total - matched // self.alloc.block_size

    # --------------------------------------------------------- host tier
    def _restorable(self, entry: SchedEntry) -> _SwapRecord | None:
        """The entry's swap record, iff restoring it beats recomputing."""
        rec = self._swap_records.get(entry.seq)
        if (rec is not None and rec.host_ids
                and self.swap_cost.prefer_swap(len(rec.host_ids),
                                               rec.consumed)):
            return rec
        return None

    def _spill_page(self, bid: int) -> int | None:
        """PrefixCache spill hook: copy one device page's rows to the host
        tier (None when the tier is full)."""
        hid = self.host.put(*self.view.read_page(bid))
        if hid is not None:
            self.trace.emit("swap-out", rid=None, tick=self.now,
                            reason="prefix-spill", pages=1,
                            tokens=self.alloc.block_size,
                            pages_in_use=self.alloc.in_use,
                            host_pages_in_use=self.host.in_use)
        return hid

    def _page_in(self, hid: int) -> int | None:
        """PrefixCache restore hook: allocate a device page and copy a
        spilled page's rows back (None when the device pool is empty)."""
        if self.alloc.num_free == 0:
            return None
        bid = self.alloc.alloc()
        self.view.write_page(bid, *self.host.get(hid))
        self.trace.emit("swap-in", rid=None, tick=self.now,
                        reason="prefix-restore", pages=1,
                        tokens=self.alloc.block_size,
                        pages_in_use=self.alloc.in_use,
                        host_pages_in_use=self.host.in_use)
        return bid

    def _drop_swap(self, entry: SchedEntry, *, swapped_in: bool = False
                   ) -> _SwapRecord | None:
        """Release an entry's host-parked pages (readmit or cancel)."""
        rec = self._swap_records.pop(entry.seq, None)
        if rec is not None:
            for hid in rec.host_ids:
                self.host.decref(hid, swapped_in=swapped_in)
        return rec

    # ------------------------------------------------------------- admit
    def _admit(self, entry: SchedEntry,
               victims: tuple[SchedEntry, ...] = ()) -> bool:
        """Place one candidate, preempting its planned ``victims`` only
        once admission is guaranteed (the budget check comes after the
        prefix match, which pins the matched pages)."""
        req: Request = entry.req
        bs = self.alloc.block_size
        feed = self._feed_of(req)
        total = pages_for(len(feed) + req.max_new - len(req.out), bs)
        rec = self._restorable(entry)
        if rec is not None:
            return self._admit_restore(entry, feed, total, rec, victims)
        # leave ≥1 token to feed so the last-position logits exist
        if self.prefix_enabled:
            matched_len, shared = self.prefix.match(feed,
                                                    max_tokens=len(feed) - 1)
        else:
            matched_len, shared = 0, []
        need = total - len(shared)
        budget = (self.alloc.num_free + self.prefix.evictable()
                  + sum(v.held_pages for v in victims))
        if need > budget:
            for bid in shared:      # lost an intra-tick race; stay waiting
                self.alloc.decref(bid)
            self.pstats.admit_retries += 1
            return False
        for v in victims:           # guaranteed to buy the admission now
            self._preempt(v)
        if need > self.alloc.num_free:
            self.prefix.evict(need - self.alloc.num_free)
        if need > self.alloc.num_free:  # pragma: no cover - budget-guarded
            for bid in shared:
                self.alloc.decref(bid)
            self.pstats.admit_retries += 1
            return False
        private = [self.alloc.alloc() for _ in range(need)]
        slot = self._free_slots()[0]
        if self.kernel == "paged":
            # zero-copy prefix reuse: the matched pages (and the fresh
            # private ones) become this slot's page-table row
            table = shared + private
            self.view.bind_slot(slot, table)
            self.pstats.cached_tokens += matched_len
        else:
            table = []
            if matched_len:         # prefix hit: pages -> slot rows, no math
                for cache, rows in zip(
                        (self.cache["self"]["k"], self.cache["self"]["v"]),
                        self.pool.read(shared)):
                    cache[:, slot, :matched_len] = to_device(
                        rows[:, :matched_len], cache.dtype, self.device)
                self.pstats.cached_tokens += matched_len
        self.active[slot] = _Slot(
            entry=entry, req=req, feed=feed,
            hashes=chain_hashes(feed, bs),
            pending=feed[matched_len:], consumed=matched_len,
            shared=shared, private=private, registered=matched_len // bs,
            table=table)
        self.sched.mark_running(entry, slot, len(private))
        dropped = self._drop_swap(entry)
        if dropped is not None:
            # a readmission sent down the recompute path: previously
            # computed rows beyond the prefix hit are re-prefilled
            self.pstats.recompute_tokens += max(0,
                                                dropped.consumed - matched_len)
        self.trace.emit("admit", rid=req.rid, slot=slot, tick=self.now,
                        feed_tokens=len(feed), cached_tokens=matched_len,
                        new_pages=len(private), shared_pages=len(shared),
                        pages_in_use=self.alloc.in_use)
        return True

    def _admit_restore(self, entry: SchedEntry, feed: list[int],
                       total: int, rec: _SwapRecord,
                       victims: tuple[SchedEntry, ...] = ()) -> bool:
        """Swap-in readmission: every page comes back as a private page,
        the parked rows are copied into them, and the slot resumes at the
        preempted position — token-exact with an uninterrupted run."""
        req: Request = entry.req
        bs = self.alloc.block_size
        need = total
        budget = (self.alloc.num_free + self.prefix.evictable()
                  + sum(v.held_pages for v in victims))
        if need > budget:
            # intra-tick race: stay waiting, the record stays parked
            self.pstats.admit_retries += 1
            return False
        for v in victims:
            self._preempt(v)
        if need > self.alloc.num_free:
            self.prefix.evict(need - self.alloc.num_free)
        if need > self.alloc.num_free:  # pragma: no cover - budget-guarded
            self.pstats.admit_retries += 1
            return False
        private = [self.alloc.alloc() for _ in range(need)]
        slot = self._free_slots()[0]
        if self.kernel == "paged":
            for bid, hid in zip(private, rec.host_ids):
                self.view.write_page(bid, *self.host.get(hid))
            table = list(private)
            self.view.bind_slot(slot, table)
        else:
            # the parked pages back into the slot's rows; rows past them
            # keep the last occupant's values, never read before the
            # decode loop rewrites them (the reference zeroes them)
            table = []
            rows = min(len(rec.host_ids) * bs, self.max_len)
            for i, cache in enumerate((self.cache["self"]["k"],
                                       self.cache["self"]["v"])):
                parked = np.concatenate([self.host.get(h)[i]
                                         for h in rec.host_ids], axis=1)
                cache[:, slot, :rows] = to_device(parked[:, :rows],
                                                  cache.dtype, self.device)
        self.active[slot] = _Slot(
            entry=entry, req=req, feed=feed,
            hashes=chain_hashes(feed, bs),
            pending=feed[rec.consumed:], consumed=rec.consumed,
            shared=[], private=private, registered=0, table=table)
        self.sched.mark_running(entry, slot, len(private))
        self._drop_swap(entry, swapped_in=True)
        self.pstats.restored_tokens += rec.consumed
        self.pstats.swap_ins += 1
        self.trace.emit("swap-in", rid=req.rid, slot=slot, tick=self.now,
                        reason="readmit", pages=len(rec.host_ids),
                        tokens=rec.consumed,
                        pages_in_use=self.alloc.in_use,
                        host_pages_in_use=self.host.in_use)
        self.trace.emit("admit", rid=req.rid, slot=slot, tick=self.now,
                        feed_tokens=len(feed), cached_tokens=0,
                        new_pages=len(private), shared_pages=0,
                        pages_in_use=self.alloc.in_use)
        return True

    def _register_blocks(self, slot: int, st: _Slot) -> None:
        """Publish newly completed full prompt blocks to the prefix cache.
        Paged pathway: the block's KV already lives in the page its table
        entry names, so registration is pure metadata (first writer wins;
        the loser keeps its private page).  Gather pathway: copy the
        slot's rows out to a private page of the host pool."""
        if not self.prefix_enabled:
            return
        bs = self.alloc.block_size
        while (st.registered < len(st.hashes)
               and (st.registered + 1) * bs <= st.consumed):
            h = st.hashes[st.registered]
            if self.kernel == "paged":
                if not self.prefix.contains(h):
                    # entries past the matched blocks are this slot's
                    # private pages: fully written, never written again
                    self.prefix.insert(h, st.table[st.registered])
            elif (not self.prefix.contains(h)
                    and st.reg_cursor < len(st.private)):
                bid = st.private[st.reg_cursor]
                st.reg_cursor += 1
                a, b = st.registered * bs, (st.registered + 1) * bs
                self.pool.write(
                    bid, to_host(self.cache["self"]["k"][:, slot, a:b]),
                    to_host(self.cache["self"]["v"][:, slot, a:b]))
                self.prefix.insert(h, bid)
            st.registered += 1

    # ------------------------------------------------------ release paths
    def _release(self, st: _Slot) -> None:
        for bid in st.shared:
            self.alloc.decref(bid)
        for bid in st.private:
            self.alloc.decref(bid)   # registered pages survive via cache ref

    def _swap_out(self, st: _Slot, slot: int) -> int:
        """Park the victim's written pages on the host tier.  Returns the
        page count parked (0: swap disabled, nothing written, or tier
        full).  Shared prefix pages are copied too: the record must
        survive the prefix cache evicting them."""
        rec = _SwapRecord(consumed=st.consumed)
        self._swap_records[st.entry.seq] = rec
        if not self.swap_enabled or st.consumed <= 0:
            return 0
        bs = self.alloc.block_size
        n_pages = pages_for(st.consumed, bs)
        if self.kernel == "paged":
            pages = [self.view.read_page(b) for b in st.table[:n_pages]]
        else:
            # the slot's written rows, zero-padded to whole pages
            rows = min(n_pages * bs, self.max_len)
            slabs = []
            for cache in (self.cache["self"]["k"], self.cache["self"]["v"]):
                slab = to_host(cache[:, slot, :rows])
                slab = np.pad(slab, ((0, 0), (0, n_pages * bs - rows))
                              + ((0, 0),) * (slab.ndim - 2))
                slabs.append(slab.reshape(slab.shape[0], n_pages, bs,
                                          *slab.shape[2:]))
            pages = [(slabs[0][:, i], slabs[1][:, i])
                     for i in range(n_pages)]
        ids: list[int] = []
        for k_rows, v_rows in pages:
            hid = self.host.put(k_rows, v_rows)
            if hid is None:             # tier full: recompute on readmit
                for h in ids:
                    self.host.decref(h)
                return 0
            ids.append(hid)
        rec.host_ids = ids
        self.pstats.swap_outs += 1
        self.trace.emit("swap-out", rid=st.req.rid, slot=slot,
                        tick=self.now, reason="preempt", pages=n_pages,
                        tokens=st.consumed,
                        pages_in_use=self.alloc.in_use,
                        host_pages_in_use=self.host.in_use)
        return n_pages

    def _preempt(self, entry: SchedEntry) -> None:
        st = self.active.pop(entry.slot)
        self.lane.clear(entry.slot)
        self._swap_out(st, entry.slot)
        if self.view is not None:
            self.view.clear_slot(entry.slot)
        self._release(st)
        self.trace.emit("preempt", rid=st.req.rid, slot=entry.slot,
                        tick=self.now, consumed=st.consumed,
                        released_pages=len(st.shared) + len(st.private),
                        pages_in_use=self.alloc.in_use)
        self.sched.mark_preempted(entry)

    def _finish(self, slot: int) -> Request:
        st = self.active.pop(slot)
        self.lane.clear(slot)
        if self.view is not None:
            self.view.clear_slot(slot)
        st.req.finished = True
        st.req.t_done = time.perf_counter()
        self._release(st)
        self.trace.emit("finish", rid=st.req.rid, slot=slot, tick=self.now,
                        tokens_out=len(st.req.out),
                        pages_in_use=self.alloc.in_use)
        self.sched.mark_done(st.entry)
        self.stats.served += 1
        return st.req

    # ------------------------------------------------------------ cancel
    def cancel(self, handle: RequestHandle) -> bool:
        """Cancel at any lifecycle stage, releasing the slot and every page
        reference the request held; blocks it registered in the prefix
        cache survive through the cache's own reference."""
        entry: SchedEntry = handle.entry
        req = handle.req
        if entry is None or entry.state == DONE or req.cancelled:
            return False
        if entry.state == RUNNING:
            st = self.active.pop(entry.slot)
            self.lane.clear(entry.slot)
            if self.view is not None:
                self.view.clear_slot(entry.slot)
            phase = "prefill" if st.pending else "decode"
            released = len(st.shared) + len(st.private)
            self._release(st)
            self.sched.mark_cancelled(entry)
        elif entry.state == PREEMPTED:
            phase, released = "preempted", 0
            self._drop_swap(entry)
            self.sched.mark_cancelled(entry)
        elif entry.state == WAITING:
            phase, released = "waiting", 0
            self.sched.mark_cancelled(entry)
        else:
            return False
        req.cancelled = True
        req.t_done = time.perf_counter()
        self.stats.cancelled += 1
        self.trace.emit("cancel", rid=req.rid, phase=phase, tick=self.now,
                        released_pages=released,
                        pages_in_use=self.alloc.in_use)
        return True

    # --------------------------------------------------------------- step
    def step(self) -> list[Request]:
        """One engine tick: scheduler plan (every ``admit_every``-th
        tick), then one chunked decode call with fused token selection."""
        self.now += self.tick_dt
        self._ticks += 1
        run_sched = (self._ticks - 1) % self.admit_every == 0
        admitted = 0
        if run_sched:
            plan = self.sched.schedule(
                free_slots=len(self._free_slots()),
                free_pages=self.alloc.num_free + self.prefix.evictable(),
                cost_fn=self._cost)
            # a candidate's victims are preempted only once its own
            # admission is guaranteed (_admit re-prices it against the
            # pool as it stands now)
            for entry in plan.admit:
                victims = tuple(plan.victims.get(entry.seq, ()))
                if not self._free_slots() and not victims:
                    break
                if not self._admit(entry, victims):
                    break   # intra-tick race: keep strict head-of-line order
                admitted += 1
        else:
            plan = Plan()
        if not self.active:
            if (run_sched and admitted == 0 and not plan.preempt
                    and self.sched.waiting
                    and all(e.arrival <= self.now
                            for e in self.sched.waiting)):
                raise RuntimeError(
                    "paged engine cannot place any waiting request: "
                    f"need more than {self.alloc.num_blocks} pages/"
                    f"{self.slots} slots")
            return []

        toks = np.zeros((self.slots, self.chunk), np.int32)
        pos = np.zeros((self.slots,), np.int32)
        n_new = np.zeros((self.slots,), np.int32)
        need_sample = any(_samples(st.req) for st in self.active.values())
        for slot, st in self.active.items():
            pos[slot] = st.consumed
            if need_sample:          # the greedy step never reads the lanes
                self.lane.set(slot, st.req)
            if st.pending:
                n = min(self.chunk, len(st.pending))
                toks[slot, :n] = st.pending[:n]
                n_new[slot] = n
            else:
                toks[slot, 0] = st.next_input
                n_new[slot] = 1

        a = self._args
        args = [self.params, self.cache, a(toks), a(pos), a(n_new)]
        if self.kernel == "paged":
            args.append(a(self.view.page_table))
            greedy = self.model.decode_paged_greedy_chunk
            sample = self.model.decode_paged_sample_chunk
        else:
            greedy = self.model.decode_greedy_chunk
            sample = self.model.decode_sample_chunk
        if need_sample:
            sampled = sample(*args, a.lanes(self.lane))
        else:
            sampled = greedy(*args)
        if self.view is not None:
            self.view.adopt(self.cache)
        nxt = sampled.cpu().numpy()
        self.stats.decode_steps += 1
        self.stats.observe_occupancy(len(self.active))
        if self.trace.enabled:       # keep the untraced tick allocation-free
            # lane kind comes from pending state, not chunk size: a
            # 1-token final prefill chunk is still a prefill lane
            lanes = [(int(n_new[s]), bool(st.pending))
                     for s, st in self.active.items()]
            self.trace.emit(
                "step", step_kind="chunk", tick=self.now, lanes=len(lanes),
                prefill_lanes=sum(1 for _, p in lanes if p),
                decode_lanes=sum(1 for _, p in lanes if not p),
                prefill_tokens=sum(n for n, p in lanes if p),
                chunk_sizes=tuple(n for n, _ in lanes))

        finished: list[int] = []
        for slot, st in self.active.items():
            req, n = st.req, int(n_new[slot])
            st.consumed += n
            if st.pending:
                st.pending = st.pending[n:]
                self.pstats.prefill_tokens += n
                self._register_blocks(slot, st)
                if st.pending:
                    continue        # mid-prefill: this lane's sample unused
                # prompt fully consumed this tick: the prefill→decode
                # phase boundary (re-fires after a preempt/readmit
                # recompute, unlike first-token)
                self.trace.emit("prefill-done", rid=req.rid, tick=self.now,
                                slot=slot, consumed=st.consumed)
            tok = int(nxt[slot])
            req.out.append(tok)
            self.stats.tokens_out += 1
            if not req.t_first:
                ttft = self.now - st.entry.arrival
                self.ttft_ticks.append(ttft)
                req.t_first = time.perf_counter()
                self.trace.emit("first-token", rid=req.rid, tick=self.now,
                                ttft_ticks=ttft)
            st.next_input = tok
            if (tok == req.eos_id or len(req.out) >= req.max_new
                    or st.consumed >= self.max_len - 1):
                finished.append(slot)
        return [self._finish(slot) for slot in finished]

    def drain(self) -> list[Request]:
        done: list[Request] = []
        while self.has_work():
            done.extend(self.step())
        return done

    # ---------------------------------------------------------- run shim
    def run(self, requests: list[Request],
            arrivals: list[float] | None = None) -> list[Request]:
        return run_requests(self, requests, arrivals)

    # -------------------------------------------------------------- report
    def report(self) -> dict:
        return {
            "engine": "paged",
            "served": self.stats.served,
            "cancelled": self.stats.cancelled,
            "decode_steps": self.stats.decode_steps,
            "tokens_out": self.stats.tokens_out,
            "mean_batch_occupancy": round(self.stats.mean_occupancy, 2),
            "prefill_tokens": self.pstats.prefill_tokens,
            "cached_tokens": self.pstats.cached_tokens,
            "prefix_hit_rate": round(self.pstats.prefix_hit_rate, 3),
            "prefix_lookups": self.prefix.stats.lookups,
            "prefix_hit_blocks": self.prefix.stats.hit_blocks,
            "prefix_miss_blocks": self.prefix.stats.miss_blocks,
            "prefix_insertions": self.prefix.stats.insertions,
            "prefix_evictions": self.prefix.stats.evictions,
            "prefix_chains": len(self.prefix),
            "page_peak_utilization": round(
                self.alloc.stats.peak_in_use / self.alloc.num_blocks, 3),
            "pages": self.alloc.num_blocks,
            "block_size": self.alloc.block_size,
            "chunk": self.chunk,
            "prefix_cache": self.prefix_enabled,
            "admit_every": self.admit_every,
            "kernel": self.kernel,
            "preemption": self.sched.preemption,
            "preemptions": self.sched.stats.preemptions,
            "swap": self.swap_enabled,
            "swap_outs": self.pstats.swap_outs,
            "swap_ins": self.pstats.swap_ins,
            "restored_tokens": self.pstats.restored_tokens,
            "recompute_tokens": self.pstats.recompute_tokens,
            "recompute_tokens_saved": self.pstats.restored_tokens,
            "swap_restore_rate": round(self.pstats.swap_restore_rate, 3),
            "prefix_spills": self.prefix.stats.spills,
            "prefix_restores": self.prefix.stats.restores,
            "host_pages": self.host.capacity,
            "host_pages_in_use": self.host.in_use,
            "host_page_peak": self.host.stats.peak_in_use,
            "compiles": 0,      # eager PyTorch compiles nothing
        }


def token_matrix(done: list[Request], n_requests: int,
                 max_new: int) -> np.ndarray:
    """Output streams as a dense int matrix (pad = -1), rid-ordered so
    completion order does not affect the comparison."""
    out = np.full((n_requests, max_new), -1, np.int64)
    for r in done:
        out[r.rid, :len(r.out)] = r.out
    return out


def compare_engines(model: Model, params: Any,
                    make_requests: Callable[[], list[Request]], *,
                    slots: int = 2, max_len: int = 64, block_size: int = 8,
                    chunk: int = 4, repeats: int = 1,
                    sampling: SamplingParams | None = None,
                    engine_kwargs: dict[str, dict] | None = None,
                    cluster: dict | None = None,
                    device: str | torch.device = "cuda"):
    """The paged engine's correctness proof, in the paper's methodology:
    the same workload under two environments (contiguous oracle vs paged)
    must agree token for token.  With ``sampling`` given, both engines
    decode the workload under those SamplingParams; counter-based keys
    make sampled streams engine-independent, so the verdict is the same
    bit-identity as greedy.

    ``engine_kwargs`` pins per-engine construction explicitly:
    ``{"contiguous": {...}, "paged": {...}}``, e.g. ``{"paged": {"kernel":
    "gather"}}`` holds the oracle verdict over the dense-fallback pathway
    and ``{"paged": {"kernel": "paged"}}`` over the page-table kernel.
    Both engines run on ``device``.

    With ``cluster`` given (a dict of ``ClusterEngine`` kwargs, e.g.
    ``{"replicas": 3, "routing": "random"}``), the comparison becomes one
    paged engine against a ``ClusterEngine`` over the same geometry, both
    on ``device``: routing moves requests between replicas, but sampled
    tokens key on ``(seed, rid, step)``, so a cluster of any size, under
    any routing policy, must reproduce the single engine's streams
    exactly.  This is the routing oracle: a router that corrupted,
    duplicated or dropped a request would break bit-identity here.

    Returns a ``core.verify.DualEnvReport`` whose verdicts CI gates on."""
    from repro_torch.core.verify import DualEnvHarness

    ek = engine_kwargs or {}
    contig_kw = dict(ek.get("contiguous", {}))
    paged_kw = dict(ek.get("paged", {}))

    def requests() -> list[Request]:
        reqs = make_requests()
        if sampling is not None:
            for r in reqs:
                r.sampling = sampling
        return reqs

    probe = requests()
    n, max_new = len(probe), max(r.max_new for r in probe)

    def run_contiguous():
        eng = ServeEngine(model, params, slots=slots, max_len=max_len,
                          device=device, **contig_kw)
        return token_matrix(eng.run(requests()), n, max_new)

    def run_paged():
        eng = PagedServeEngine(model, params, slots=slots, max_len=max_len,
                               block_size=block_size, chunk=chunk,
                               device=device, **paged_kw)
        return token_matrix(eng.run(requests()), n, max_new)

    harness = DualEnvHarness(repeats=repeats, warmup=0)
    if cluster is not None:
        # routing oracle: one paged engine against the cluster router
        from repro_torch.serve.cluster import ClusterEngine  # avoid a cycle

        cluster_kw = dict(cluster)

        def run_cluster():
            eng = ClusterEngine(model, params, slots=slots, max_len=max_len,
                                block_size=block_size, chunk=chunk,
                                device=device, **cluster_kw)
            return token_matrix(eng.run(requests()), n, max_new)

        return harness.compare("paged", run_paged,
                               "cluster", run_cluster, rtol=1e-9, atol=0.5)
    return harness.compare("contiguous", run_contiguous,
                           "paged", run_paged, rtol=1e-9, atol=0.5)
