"""Request scheduler: FCFS within priority, preemption on OOM.

The port's own copy of ``repro.serve.scheduler`` (pure Python).

The scheduler is deliberately model-free: it sees abstract entries with a
priority, an arrival time, and a page cost (computed by the engine's cost
function, which nets out prefix-cache hits), and produces a ``Plan`` of
admissions and preemptions.  The engine executes the plan; the clock is
injected so tests drive it with a synthetic timeline and get byte-for-byte
deterministic schedules.

Policy
------
- Admission order: higher priority first, then submission order (FCFS).
  Head-of-line within the sorted order is strict: if the head candidate
  cannot be placed (even after preemption), nothing behind it is admitted
  — this keeps FCFS provable in tests and avoids starving big requests.
- Preemption: a candidate that cannot be placed may evict running entries
  of *strictly lower* priority (lowest priority first, most recently
  submitted first — the cheapest recompute), reclaiming their slot and
  pages.  Preempted entries return to the waiting queue keeping their
  original submission order.  On readmission the engine picks the cheaper
  of two equivalent pathways via ``SwapCostModel``: swap the victim's
  host-parked pages back in, or re-prefill prompt + generated-so-far
  (recompute).  Both yield the token stream of an uninterrupted run —
  greedy decoding is deterministic and sampling keys on
  ``(seed, rid, step)``.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.audit.trace import NULL_TRACER, Tracer

WAITING = "waiting"
RUNNING = "running"
PREEMPTED = "preempted"
DONE = "done"
CANCELLED = "cancelled"


@dataclass
class SchedEntry:
    req: Any
    priority: int = 0          # higher wins
    arrival: float = 0.0       # clock time the request becomes visible
    seq: int = 0               # submission order (FCFS tiebreak)
    state: str = WAITING
    slot: int | None = None
    held_pages: int = 0        # set by the engine at admission
    preemptions: int = 0
    t_admitted: float = 0.0


@dataclass
class Plan:
    admit: list[SchedEntry] = field(default_factory=list)
    preempt: list[SchedEntry] = field(default_factory=list)
    # victim attribution: cand.seq -> the victims picked *for that
    # candidate*.  The engine commits a candidate's preemptions only when
    # its admission actually goes through, so an intra-tick evictability
    # race cannot flush running work for nothing.  ``preempt`` stays the
    # flat aggregate (same entries, plan order).
    victims: dict[int, list[SchedEntry]] = field(default_factory=dict)


@dataclass(frozen=True)
class SwapCostModel:
    """Prices a preempted entry's two readmission pathways in a common
    unit (token-recompute equivalents).

    Restoring swapped pages costs a per-page transfer constant — the
    host->device copy latency expressed in how many tokens could have
    been prefilled in the same time.  Recomputing costs one unit per
    previously-computed token re-prefilled.  Swap wins whenever the
    transfer is cheaper than the prefill it replaces, which for any
    reasonable block size is almost always — except degenerate victims
    preempted with under ``swap_cost_per_page`` tokens written, where
    recompute is genuinely cheaper than the copy.
    """
    swap_cost_per_page: float = 2.0
    recompute_cost_per_token: float = 1.0

    def restore_cost(self, pages: int) -> float:
        return self.swap_cost_per_page * pages

    def recompute_cost(self, tokens: int) -> float:
        return self.recompute_cost_per_token * tokens

    def prefer_swap(self, pages: int, tokens: int) -> bool:
        return self.restore_cost(pages) <= self.recompute_cost(tokens)


@dataclass
class SchedStats:
    admissions: int = 0
    preemptions: int = 0
    readmissions: int = 0
    cancellations: int = 0


class Scheduler:
    def __init__(self, *, slots: int,
                 clock: Callable[[], float] | None = None,
                 tracer: Tracer | None = None,
                 preemption: bool = True):
        self.slots = slots
        self.clock = clock or time.perf_counter
        self.trace = tracer or NULL_TRACER
        # preemption=False models a misconfigured scheduler: no running
        # entry is ever evicted, so a priority burst queues behind
        # long-running work — output streams are unchanged (admission
        # order still sorts by priority; deterministic sampling is
        # schedule-invariant) but tail TTFT inflates under overload.
        # The audit's quantile SLO expectations exist to catch this.
        self.preemption = preemption
        self._seq = itertools.count()
        self.waiting: list[SchedEntry] = []
        self.running: list[SchedEntry] = []
        self.stats = SchedStats()

    # ------------------------------------------------------------ intake
    def submit(self, req: Any, *, priority: int = 0,
               arrival: float | None = None) -> SchedEntry:
        e = SchedEntry(req=req, priority=priority,
                       arrival=self.clock() if arrival is None else arrival,
                       seq=next(self._seq))
        self.waiting.append(e)
        return e

    @property
    def pending(self) -> int:
        return len(self.waiting)

    @property
    def active(self) -> int:
        return len(self.running)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # ------------------------------------------------------------ planning
    def schedule(self, *, free_slots: int, free_pages: int,
                 cost_fn: Callable[[SchedEntry], int]) -> Plan:
        """One planning pass.  ``free_pages`` should include pages the
        engine can reclaim from the prefix cache (evictable); ``cost_fn``
        returns net new pages an entry needs if admitted now."""
        now = self.clock()
        plan = Plan()
        ready = sorted((e for e in self.waiting if e.arrival <= now),
                       key=lambda e: (-e.priority, e.seq))
        # victim pool: lowest priority first, most recent first
        victims = (sorted(self.running, key=lambda e: (e.priority, -e.seq))
                   if self.preemption else [])
        for cand in ready:
            need = cost_fn(cand)
            # tentative victim picks: committed only if they buy admission
            picked: list[SchedEntry] = []
            slots_if, pages_if = free_slots, free_pages
            while (slots_if <= 0 or pages_if < need) and victims:
                v = victims[0]
                if v.priority >= cand.priority:
                    break  # never preempt equal-or-higher priority
                victims.pop(0)
                picked.append(v)
                slots_if += 1
                pages_if += v.held_pages
            if slots_if > 0 and pages_if >= need:
                plan.preempt.extend(picked)
                if picked:
                    plan.victims[cand.seq] = picked
                plan.admit.append(cand)
                free_slots, free_pages = slots_if - 1, pages_if - need
            else:
                victims = picked + victims   # un-pick: admission failed
                break  # strict head-of-line: preserve FCFS order
        return plan

    # ------------------------------------------------------- state changes
    def mark_running(self, e: SchedEntry, slot: int, held_pages: int) -> None:
        readmit = e.state == PREEMPTED
        if readmit:
            self.stats.readmissions += 1
        self.waiting.remove(e)
        self.running.append(e)
        e.state, e.slot, e.held_pages = RUNNING, slot, held_pages
        e.t_admitted = self.clock()
        self.stats.admissions += 1
        self.trace.emit("sched-readmit" if readmit else "sched-admit",
                        rid=getattr(e.req, "rid", None),
                        seq=e.seq, priority=e.priority, slot=slot,
                        held_pages=held_pages,
                        wait=e.t_admitted - e.arrival)

    def mark_preempted(self, e: SchedEntry) -> None:
        self.running.remove(e)
        self.waiting.append(e)
        self.trace.emit("sched-preempt", rid=getattr(e.req, "rid", None),
                        seq=e.seq, priority=e.priority,
                        slot=e.slot, released_pages=e.held_pages)
        e.state, e.slot, e.held_pages = PREEMPTED, None, 0
        e.preemptions += 1
        self.stats.preemptions += 1

    def mark_done(self, e: SchedEntry) -> None:
        self.running.remove(e)
        e.state, e.slot, e.held_pages = DONE, None, 0
        self.trace.emit("sched-done", rid=getattr(e.req, "rid", None),
                        seq=e.seq, priority=e.priority)

    def mark_cancelled(self, e: SchedEntry) -> None:
        """Drop an entry at any pre-DONE stage.  The engine releases the
        slot and pages before calling this; the scheduler just forgets the
        entry (a cancelled entry never re-enters the waiting queue)."""
        if e.state == RUNNING:
            self.running.remove(e)
        elif e.state in (WAITING, PREEMPTED):
            self.waiting.remove(e)
        else:
            raise ValueError(f"cannot cancel entry in state {e.state!r}")
        was = e.state
        e.state, e.slot, e.held_pages = CANCELLED, None, 0
        self.stats.cancellations += 1
        self.trace.emit("sched-cancel", rid=getattr(e.req, "rid", None),
                        seq=e.seq, priority=e.priority, was=was)
