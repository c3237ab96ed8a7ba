"""Structured runtime event tracer: bounded ring buffer + scoped spans.

The port's own copy of ``repro.audit.trace`` (pure Python; copied so the
port never loads the JAX package).  ``KNOWN_KINDS`` must stay equal to
the reference's: ``tests/test_torch_isolation.py`` holds them equal.

Hot paths (engine ticks, scheduler decisions, jitted-step dispatch) emit
small dict-payload events; the buffer is a fixed-capacity ring so a
long-running server pays O(1) per event and bounded memory, while
per-kind counters survive ring overflow so expectation checks see exact
totals even when old events have been dropped.

``NULL_TRACER`` is a shared do-nothing instance: instrumented code holds
an unconditional ``tracer.emit(...)`` call and the disabled path costs
one attribute lookup + empty call — no ``if tracer:`` branches sprinkled
through engines.

Subscribers (``tracer.subscribe``) observe every event *at emission*,
before the ring can drop it — the live-metrics layer
(``audit.metrics``) is built on this: histograms and counters stay
exact on long runs whose early events the bounded ring has already
evicted.
"""
from __future__ import annotations

import time
from collections import Counter, deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

#: Every event kind the instrumented layers may emit.  The emit-kind
#: lint (tests/test_audit.py) greps ``tracer.emit("...")`` /
#: ``tracer.span("...")`` literals out of ``src/``, ``benchmarks/``,
#: and ``scripts/`` and asserts
#: they all appear here, so the metrics layer and the expectation
#: registry can never silently miss a pathway because someone added an
#: emitter without declaring its kind.
KNOWN_KINDS = frozenset({
    # serve.engine — request lifecycle + hot loop (both engines)
    "engine-init", "submit", "admit", "prefill-done", "first-token", "step",
    "preempt", "finish", "cancel", "compile",
    # serve.engine — KV memory tiering (device pool <-> host swap tier):
    # preempt/readmit page parking and cold-prefix spill/page-in
    "swap-out", "swap-in",
    # serve.scheduler — planning decisions
    "sched-admit", "sched-readmit", "sched-preempt", "sched-done",
    "sched-cancel",
    # serve.cluster — multi-replica routing decisions
    "route",
    # launch.train — training loop + checkpointing
    "train-step", "ckpt-save", "ckpt-restore",
    # launch.dryrun — lowering/compile attestation cells
    "dryrun-lower", "dryrun-compile", "dryrun-error",
})


@dataclass
class TraceEvent:
    seq: int                      # monotonic per-tracer event index
    t: float                      # tracer clock at emission
    kind: str
    data: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"seq": self.seq, "t": self.t, "kind": self.kind, **self.data}


class Tracer:
    """Bounded event recorder with exact per-kind counts.

    ``clock`` is injectable (engines pass their synthetic tick clock) so
    traces replay deterministically in tests; default is wall time.
    """

    enabled = True

    def __init__(self, capacity: int = 4096,
                 clock: Callable[[], float] | None = None):
        self.capacity = capacity
        self.clock = clock or time.perf_counter
        self._ring: deque[TraceEvent] = deque(maxlen=capacity)
        self._counts: Counter[str] = Counter()
        self._seq = 0
        self._subs: list[Callable[[TraceEvent], None]] = []

    # ------------------------------------------------------------- record
    def emit(self, kind: str, /, **data: Any) -> None:
        # kind is positional-only so a payload may carry its own "kind"
        ev = TraceEvent(self._seq, self.clock(), kind, data)
        self._ring.append(ev)
        self._counts[kind] += 1
        self._seq += 1
        for sub in self._subs:
            sub(ev)

    # --------------------------------------------------------- subscribe
    def subscribe(self, fn: Callable[[TraceEvent], None]) -> Callable:
        """Register a live observer called with every event at emission —
        *before* the bounded ring can evict it, so a subscriber sees the
        complete stream even when the ring has wrapped (the metrics
        layer's feed contract).  Returns ``fn`` so callers can hold it
        for ``unsubscribe``."""
        self._subs.append(fn)
        return fn

    def unsubscribe(self, fn: Callable[[TraceEvent], None]) -> None:
        self._subs.remove(fn)

    @contextmanager
    def span(self, kind: str, /, **data: Any) -> Iterator[dict]:
        """Scoped span: emits ``kind`` once on exit carrying both the
        entry clock reading (``t_start``) and the measured duration
        (``dt_s``), so span trees reconstruct without inferring starts.
        Reads the tracer's injected ``clock`` — under a synthetic tick
        clock the payload is deterministic.  The yielded dict lets the
        body attach results (e.g. a loss value) to the closing event;
        body keys override span kwargs on collision, and
        ``t_start``/``dt_s`` always win."""
        t0 = self.clock()
        extra: dict = {}
        try:
            yield extra
        finally:
            self.emit(kind, **{**data, **extra, "t_start": t0,
                               "dt_s": self.clock() - t0})

    # -------------------------------------------------------------- query
    def events(self, kind: str | None = None) -> list[TraceEvent]:
        if kind is None:
            return list(self._ring)
        return [e for e in self._ring if e.kind == kind]

    def last(self, kind: str) -> TraceEvent | None:
        for e in reversed(self._ring):
            if e.kind == kind:
                return e
        return None

    def count(self, kind: str) -> int:
        """Exact lifetime count for ``kind`` (survives ring overflow)."""
        return self._counts[kind]

    @property
    def emitted(self) -> int:
        return self._seq

    @property
    def dropped(self) -> int:
        return self._seq - len(self._ring)

    def summary(self) -> dict:
        return {
            "emitted": self.emitted,
            "retained": len(self._ring),
            "dropped": self.dropped,
            "counts": dict(self._counts),
        }


class _NullTracer(Tracer):
    """Do-nothing tracer: instrumentation points call it unconditionally."""

    enabled = False

    def __init__(self):
        super().__init__(capacity=1)

    def emit(self, kind: str, /, **data: Any) -> None:  # noqa: ARG002
        pass

    @contextmanager
    def span(self, kind: str, /, **data: Any) -> Iterator[dict]:  # noqa: ARG002
        yield {}


NULL_TRACER = _NullTracer()
