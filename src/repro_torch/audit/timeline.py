"""Per-request timeline reconstruction and latency attribution.

The audit stack so far gates *aggregates*: counters, hit rates, and SLO
quantiles.  When a ``pathway-slo`` finding fires they cannot say whether
a request's latency was queue wait, preemption gaps, prefill chunking,
decode pacing, or a routing detour.  This module reads the request
lifecycle back out of the ``Tracer`` event stream —

    submit → [route] → admit → prefill chunks → first-token →
    decode steps → [preempt → readmit → re-prefill ...] → finish/cancel

— and decomposes every request's end-to-end latency into named phases
that **provably sum to the total**:

    ``routing``     front door → router placement (cluster runs only)
    ``queue_wait``  placed/submitted → first admission
    ``prefill``     admission → prompt fully consumed (per segment)
    ``decode``      prompt consumed → preemption or completion
    ``preempted``   eviction → readmission (recompute pays into prefill)

Exactness is by construction: phase boundaries are the engines' synthetic
tick-clock payloads converted to ``fractions.Fraction`` (every float is
an exact binary rational), and the spans telescope — consecutive
boundaries partition ``[arrival, end]`` — so the phase sums equal the
total *in ℚ*, not merely within float rounding.  Shares therefore sum to
exactly 1 for every closed request, which is what lets the benchmarks
ledger them with zero tolerance.

Two consumers sit on top:

- ``attribution`` — which phase dominates the p99-TTFT request, plus
  population shares; feeds the ``ExpectedSignature`` attribution bounds
  (``pathway-attribution`` findings) and the workload-SLO ledger.
- ``to_chrome_trace`` / ``chrome_trace_bytes`` — Chrome-trace-event JSON
  (load in Perfetto / ``chrome://tracing``): one process per replica,
  one thread per slot (waiting phases ride a synthetic ``queue`` track).
  Built purely from tick payloads, so the same seed + trace renders
  byte-identical output (the ``/timeline`` endpoint's determinism bar).
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Any, Iterable

from repro_torch.audit.trace import TraceEvent, Tracer

#: Phase taxonomy.  The tuple order is also the deterministic tie-break
#: when two phases hold an equal share (earlier wins).
PHASES = ("routing", "queue_wait", "prefill", "decode", "preempted")

#: Lifecycle kinds that bound phases, with the within-tick ordering the
#: engines guarantee (admission precedes the chunk that may finish the
#: prompt, which precedes the sampled first token, which precedes any
#: same-tick completion).  finish/cancel share a rank: at most one ends
#: a request.
_ORDER = {"submit": 0, "route": 1, "admit": 2, "prefill-done": 3,
          "first-token": 4, "preempt": 5, "finish": 6, "cancel": 6}

#: Synthetic Chrome-trace thread id for off-slot (waiting) spans — real
#: slots are small integers, so the queue track sorts last.
QUEUE_TID = 9999


def _fr(v: Any) -> Fraction:
    """Exact rational from a tick payload (floats are binary rationals,
    so this loses nothing)."""
    return v if isinstance(v, Fraction) else Fraction(v)


@dataclass(frozen=True)
class Span:
    """One contiguous phase interval on the tick clock (exact bounds)."""

    phase: str
    start: Fraction
    end: Fraction
    slot: int | None = None      # occupied slot (prefill/decode spans only)

    @property
    def length(self) -> Fraction:
        return self.end - self.start


@dataclass
class RequestTimeline:
    """One request's reconstructed lifecycle: ordered spans partitioning
    ``[arrival, end]`` plus the labels the exporters and detectors need."""

    rid: int
    arrival: Fraction
    spans: list[Span] = field(default_factory=list)
    end: Fraction | None = None          # finish/cancel tick; None = in flight
    outcome: str = "in-flight"           # finished | cancelled | in-flight
    replica: int | None = None           # from the route event (cluster runs)
    slots: list[int] = field(default_factory=list)   # slot per admission
    first_token: Fraction | None = None
    preemptions: int = 0
    tokens_out: int = 0
    open_phase: str | None = None        # in-flight: phase still running
    open_since: Fraction | None = None

    # ------------------------------------------------------------- totals
    def total(self) -> Fraction | None:
        return None if self.end is None else self.end - self.arrival

    def phases(self) -> dict[str, Fraction]:
        """Exact per-phase time.  For closed requests
        ``sum(phases().values()) == total()`` holds in ℚ."""
        out = {p: Fraction(0) for p in PHASES}
        for s in self.spans:
            out[s.phase] += s.length
        return out

    def shares(self) -> dict[str, Fraction]:
        """Exact phase fractions of the end-to-end latency; sums to
        exactly 1.  Empty for in-flight or zero-latency requests."""
        total = self.total()
        if not total:
            return {}
        return {p: v / total for p, v in self.phases().items()}

    # --------------------------------------------------------------- ttft
    def ttft(self) -> Fraction | None:
        if self.first_token is None:
            return None
        return self.first_token - self.arrival

    def phases_until(self, t: Fraction) -> dict[str, Fraction]:
        """Exact per-phase time clipped to ``[arrival, t]``."""
        out = {p: Fraction(0) for p in PHASES}
        for s in self.spans:
            hi = min(s.end, t)
            if hi > s.start:
                out[s.phase] += hi - s.start
        return out

    def ttft_phases(self) -> dict[str, Fraction]:
        if self.first_token is None:
            return {}
        return self.phases_until(self.first_token)

    def ttft_shares(self) -> dict[str, Fraction]:
        """Exact phase fractions of TTFT (sums to exactly 1); empty when
        the first token has not landed or TTFT is zero."""
        ttft = self.ttft()
        if not ttft:
            return {}
        return {p: v / ttft for p, v in self.ttft_phases().items()}

    # ------------------------------------------------------------ export
    def describe(self) -> dict:
        """JSON-able summary (floats; the exact rationals stay internal)."""
        out = {
            "rid": self.rid,
            "arrival": float(self.arrival),
            "end": None if self.end is None else float(self.end),
            "outcome": self.outcome,
            "replica": self.replica,
            "slots": list(self.slots),
            "ttft_ticks": (None if self.ttft() is None
                           else float(self.ttft())),
            "preemptions": self.preemptions,
            "tokens_out": self.tokens_out,
            "phases": {p: float(v) for p, v in self.phases().items()},
            "shares": {p: float(v) for p, v in self.shares().items()},
            "spans": [{"phase": s.phase, "start": float(s.start),
                       "end": float(s.end), "slot": s.slot}
                      for s in self.spans],
        }
        if self.end is None and self.open_phase is not None:
            out["open_phase"] = self.open_phase
            out["open_since"] = (None if self.open_since is None
                                 else float(self.open_since))
        return out


# ============================================================ reconstruction


def _records(source: Any) -> Iterable[dict]:
    """Normalise an event source to payload dicts: a ``Tracer``, an
    ``EventLog`` (anything with ``records()``), or an iterable of
    ``TraceEvent``/dict."""
    if isinstance(source, Tracer):
        return (e.to_dict() for e in source.events())
    if hasattr(source, "records"):
        return source.records()
    return (e.to_dict() if isinstance(e, TraceEvent) else e for e in source)


def build_timelines(*sources: Any) -> dict[int, RequestTimeline]:
    """Reconstruct per-request timelines from one or more event sources.

    Cluster runs merge naturally: pass the cluster tracer *and* the
    replica tracers — ``submit``/``route`` events the router mirrors
    into the chosen replica's tracer are deduplicated by (kind, tick),
    and the replica label comes from the ``route`` payload.  Non-
    lifecycle events (``step``, ``sched-*``, ``engine-init``, ...) are
    ignored, so the full ``EventLog`` stream can be fed unseen."""
    by_rid: dict[int, list[dict]] = {}
    for source in sources:
        for rec in _records(source):
            kind = rec.get("kind")
            rid = rec.get("rid")
            if kind not in _ORDER or rid is None:
                continue
            if kind != "submit" and "tick" not in rec:
                continue       # phase boundaries need the tick clock
            by_rid.setdefault(rid, []).append(rec)
    out: dict[int, RequestTimeline] = {}
    for rid in sorted(by_rid):
        ordered = sorted(
            by_rid[rid],
            key=lambda r: (_fr(r.get("tick", r.get("arrival", 0.0))),
                           _ORDER[r["kind"]]))
        tl = _build_one(rid, ordered)
        if tl is not None:
            out[rid] = tl
    return out


def _build_one(rid: int, ordered: list[dict]) -> RequestTimeline | None:
    tl: RequestTimeline | None = None
    state = "queue_wait"
    cur: Fraction | None = None
    seen: set[tuple[str, Fraction]] = set()

    def close(phase: str, t: Fraction, slot: int | None = None) -> None:
        nonlocal cur
        if t > cur:
            tl.spans.append(Span(phase, cur, t, slot=slot))
        cur = t

    for rec in ordered:
        kind = rec["kind"]
        if kind == "submit":
            if tl is None:
                arrival = _fr(rec.get("arrival", rec.get("tick", 0.0)))
                tl = RequestTimeline(rid=rid, arrival=arrival)
                cur = arrival
            continue
        t = _fr(rec["tick"])
        if (kind, t) in seen:
            continue        # cluster-mirrored duplicate (route) or replay
        seen.add((kind, t))
        if tl is None:
            # submit evicted from the bounded ring: the timeline starts
            # at the first retained boundary (a window, not a census)
            tl = RequestTimeline(rid=rid,
                                 arrival=_fr(rec.get("arrival", rec["tick"])))
            cur = tl.arrival
        slot = tl.slots[-1] if tl.slots else None
        if kind == "route":
            close("routing", t)
            state = "queue_wait"
            tl.replica = rec.get("replica")
        elif kind == "admit":
            close(state, t)             # queue_wait or preempted gap
            state = "prefill"
            tl.slots.append(rec.get("slot"))
        elif kind == "prefill-done":
            close("prefill", t, slot=slot)
            state = "decode"
        elif kind == "first-token":
            if tl.first_token is None:
                tl.first_token = t
        elif kind == "preempt":
            close(state, t, slot=slot if state in ("prefill", "decode")
                  else None)
            state = "preempted"
            tl.preemptions += 1
        elif kind in ("finish", "cancel"):
            close(state, t, slot=slot if state in ("prefill", "decode")
                  else None)
            tl.end = t
            tl.outcome = "finished" if kind == "finish" else "cancelled"
            tl.tokens_out = rec.get("tokens_out", tl.tokens_out)
    if tl is not None and tl.end is None:
        tl.open_phase, tl.open_since = state, cur
    return tl


# ============================================================== attribution


def attribution(timelines: dict[int, RequestTimeline],
                q: float = 0.99) -> dict:
    """Aggregate latency attribution over a set of timelines.

    Picks the nearest-rank ``q``-quantile request by TTFT (ties broken
    by rid, so the pick is deterministic) and reports which phase
    dominates *its* first-token latency, alongside population-level
    phase shares of total end-to-end latency.  Everything is computed in
    exact rationals and exported as floats."""
    closed = [tl for tl in timelines.values()
              if tl.end is not None and tl.ttft() is not None]
    if not closed:
        return {}
    ordered = sorted(closed, key=lambda tl: (tl.ttft(), tl.rid))
    worst = ordered[min(math.ceil(q * len(ordered)), len(ordered)) - 1]
    shares = worst.ttft_shares()
    dominant = None
    if shares:
        best = max(shares.values())
        dominant = next(p for p in PHASES if shares[p] == best)

    pop_total = sum((tl.total() for tl in closed), Fraction(0))
    pop_phase = {p: Fraction(0) for p in PHASES}
    for tl in closed:
        for p, v in tl.phases().items():
            pop_phase[p] += v
    pop_shares = ({p: float(v / pop_total) for p, v in pop_phase.items()}
                  if pop_total else {})
    return {
        "requests": len(closed),
        "p99_ttft_ticks": float(worst.ttft()),
        "p99_rid": worst.rid,
        "dominant_phase": dominant,
        "p99_shares": {p: float(v) for p, v in shares.items()},
        "population_shares": pop_shares,
        "preempted_share": pop_shares.get("preempted", 0.0),
    }


# ========================================================== chrome export


def to_chrome_trace(timelines: dict[int, RequestTimeline], *,
                    tick_us: float = 1000.0) -> dict:
    """Chrome-trace-event JSON (Perfetto / ``chrome://tracing``): one
    process per replica (pid = replica index; single-engine runs are
    pid 0), one thread per slot, plus a synthetic ``queue`` thread per
    process carrying the off-slot phases (routing / queue_wait /
    preempted).  One engine tick renders as ``tick_us`` microseconds.

    Deterministic: events are emitted in sorted (rid, span) order from
    exact tick rationals — no wall clock anywhere."""
    events: list[dict] = []
    tracks: set[tuple[int, int]] = set()
    for rid in sorted(timelines):
        tl = timelines[rid]
        pid = tl.replica if tl.replica is not None else 0
        for s in tl.spans:
            tid = s.slot if s.slot is not None else QUEUE_TID
            tracks.add((pid, tid))
            events.append({
                "ph": "X", "cat": "request", "name": s.phase,
                "pid": pid, "tid": tid,
                "ts": float(s.start * _fr(tick_us)),
                "dur": float(s.length * _fr(tick_us)),
                "args": {"rid": tl.rid, "phase": s.phase,
                         "outcome": tl.outcome},
            })
    meta: list[dict] = []
    for pid in sorted({p for p, _ in tracks}):
        meta.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                     "args": {"name": f"replica {pid}"}})
    for pid, tid in sorted(tracks):
        name = "queue" if tid == QUEUE_TID else f"slot {tid}"
        meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                     "tid": tid, "args": {"name": name}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms",
            "otherData": {"tick_us": tick_us,
                          "requests": len(timelines)}}


def chrome_trace_bytes(timelines: dict[int, RequestTimeline], *,
                       tick_us: float = 1000.0) -> bytes:
    """The ``/timeline`` body: canonical JSON rendering (sorted keys,
    fixed separators) of ``to_chrome_trace`` — same seed + trace ⇒
    byte-identical output."""
    doc = to_chrome_trace(timelines, tick_us=tick_us)
    return (json.dumps(doc, sort_keys=True,
                       separators=(",", ":")) + "\n").encode()
