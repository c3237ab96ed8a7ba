"""Live serving metrics: Tracer-fed registry, HTTP exposition, log export.

The audit pipeline so far is a *batch* artifact — traces and ledgers are
judged after a run ends.  This module makes the same evidence available
while the server is running, in the spirit of the paper's continuous
"verify the pathway, not just the output" loop:

- ``MetricsRegistry`` — counters, gauges, and fixed-bucket histograms.
  Histogram quantiles are nearest-bucket-bound estimates over declared
  bucket edges, so two runs that observe the same tick-clock values
  render byte-identical output (no wall clock anywhere in the math).
- ``ServeMetrics`` — the binding from ``Tracer`` events to metrics: a
  subscription hook (``tracer.subscribe``) maps the request-lifecycle
  and scheduler events onto TTFT / inter-token-gap / page-occupancy
  histograms and pathway counters as they are emitted, before the
  bounded ring can drop them.
- ``EventLog`` — structured queryable export of the event stream:
  bounded JSONL with filter-by kind / rid / tick-window reads (the
  read-side contract a log service exposes to operators).
- ``MetricsServer`` — a stdlib ``http.server`` endpoint: ``/metrics``
  (Prometheus text exposition), ``/metrics.json`` (snapshot),
  ``/healthz``, ``/events`` (filtered JSONL), ``/timeline``
  (Chrome-trace JSON of the reconstructed per-request timelines —
  ``audit.timeline``), and ``/requests/<rid>`` (one request's full
  event history + phase decomposition).  Routing is a pure
  ``handle(path)`` function so tests exercise the full endpoint
  contract without binding a port; ``serve()`` binds it for real
  (``launch.serve --metrics-port``).
"""
from __future__ import annotations

import bisect
import json
import math
import threading
from collections import deque
from typing import Any, Callable, Iterable
from urllib.parse import parse_qs, urlsplit

from repro_torch.audit.timeline import build_timelines, chrome_trace_bytes
from repro_torch.audit.trace import TraceEvent, Tracer

# --------------------------------------------------------------- buckets
#: Fixed histogram bucket upper bounds (tick clock / ratios).  Declared
#: once so every consumer — engines, benchmarks, dashboards — bins
#: identically and snapshots stay comparable across runs and sites.
TTFT_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)
GAP_BUCKETS = (0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0)
OCCUPANCY_BUCKETS = (0.1, 0.25, 0.5, 0.75, 0.9, 1.0)


def _fmt(v: float) -> str:
    """Deterministic number formatting for the text exposition: integral
    values render as integers, the rest as repr (shortest round-trip)."""
    f = float(v)
    if math.isfinite(f) and f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_suffix(labels: dict[str, str] | None,
                  extra: dict[str, str] | None = None) -> str:
    """Deterministic ``{k="v",...}`` rendering: label keys sorted, values
    escaped per the Prometheus text format; ``extra`` (the histogram
    ``le`` bound) renders last.  Empty labels render as the empty string,
    so unlabelled series keep their exact pre-label byte format."""
    items = sorted((labels or {}).items()) + list((extra or {}).items())
    if not items:
        return ""
    def esc(v):
        return str(v).replace("\\", r"\\").replace('"', r'\"').replace(
            "\n", r"\n")
    return "{" + ",".join(f'{k}="{esc(v)}"' for k, v in items) + "}"


class Counter:
    """Monotonic counter."""

    def __init__(self, name: str, help: str = "",
                 labels: dict[str, str] | None = None):
        self.name, self.help = name, help
        self.labels = dict(labels or {})
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name}: negative increment {v}")
        self.value += v


class Gauge:
    """Point-in-time value (set to the latest observation)."""

    def __init__(self, name: str, help: str = "",
                 labels: dict[str, str] | None = None):
        self.name, self.help = name, help
        self.labels = dict(labels or {})
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket cumulative histogram (Prometheus semantics).

    ``buckets`` are finite upper bounds; an implicit ``+Inf`` bucket
    catches the tail.  ``quantile`` returns the upper bound of the first
    bucket whose cumulative count reaches the rank — a deterministic
    function of the observed values and the declared edges (observations
    past the last edge report the last finite edge: the estimate is
    clamped, never invented).
    """

    def __init__(self, name: str, help: str = "",
                 buckets: tuple[float, ...] = TTFT_BUCKETS,
                 labels: dict[str, str] | None = None):
        if list(buckets) != sorted(buckets) or len(set(buckets)) != len(buckets):
            raise ValueError(f"histogram {name}: buckets must be strictly "
                             f"increasing, got {buckets}")
        self.name, self.help = name, help
        self.labels = dict(labels or {})
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)   # +Inf last
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.buckets, float(v))] += 1
        self.sum += float(v)
        self.count += 1

    def quantile(self, q: float) -> float | None:
        """Nearest-rank quantile over bucket upper bounds; None if empty."""
        if not 0.0 < q <= 1.0:
            raise ValueError(f"quantile must be in (0, 1], got {q}")
        if self.count == 0:
            return None
        rank = math.ceil(q * self.count)
        cum = 0
        for i, n in enumerate(self.counts):
            cum += n
            if cum >= rank:
                return self.buckets[min(i, len(self.buckets) - 1)]
        return self.buckets[-1]  # pragma: no cover - cum always reaches

    def snapshot(self) -> dict:
        cum, cum_counts = 0, []
        for n in self.counts:
            cum += n
            cum_counts.append(cum)
        return {
            "buckets": {_fmt(b): cum_counts[i]
                        for i, b in enumerate(self.buckets)},
            "inf": cum_counts[-1],
            "sum": round(self.sum, 6),
            "count": self.count,
            "p50": self.quantile(0.5),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Named metrics with Prometheus text + JSON snapshot rendering.

    A metric is a *series*: a name plus an optional label set (e.g. one
    ``serve_tokens_out_total`` series per cluster replica, labelled
    ``{replica="0"}``).  Registration is idempotent by (name, labels) —
    asking again returns the same instance; a name registered as one
    type cannot be re-registered as another, with or without labels.
    Rendering groups series of a name under one HELP/TYPE header and
    iterates in sorted (name, labels) order so output bytes are a pure
    function of the metric values.
    """

    def __init__(self):
        self._metrics: dict[tuple[str, str], Counter | Gauge | Histogram] = {}

    def _add(self, kind, name: str, help: str,
             labels: dict[str, str] | None = None, **kw):
        key = (name, _label_suffix(labels))
        for (n, _), existing in self._metrics.items():
            if n == name and not isinstance(existing, kind):
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{type(existing).__name__}")
        cur = self._metrics.get(key)
        if cur is not None:
            return cur
        m = kind(name, help, labels=labels, **kw)
        self._metrics[key] = m
        return m

    def counter(self, name: str, help: str = "",
                labels: dict[str, str] | None = None) -> Counter:
        return self._add(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: dict[str, str] | None = None) -> Gauge:
        return self._add(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] = TTFT_BUCKETS,
                  labels: dict[str, str] | None = None) -> Histogram:
        return self._add(Histogram, name, help, labels, buckets=buckets)

    def get(self, name: str, labels: dict[str, str] | None = None):
        return self._metrics[(name, _label_suffix(labels))]

    def series(self, name: str) -> list:
        """All series registered under ``name``, label-sorted."""
        return [m for (n, _), m in sorted(self._metrics.items())
                if n == name]

    # ---------------------------------------------------------- renderers
    def render_prometheus(self) -> str:
        """Prometheus text exposition format, deterministically ordered."""
        lines: list[str] = []
        prev_name = None
        for (name, suffix) in sorted(self._metrics):
            m = self._metrics[(name, suffix)]
            if name != prev_name:
                prev_name = name
                if m.help:
                    lines.append(f"# HELP {name} {m.help}")
                kind = ("counter" if isinstance(m, Counter)
                        else "gauge" if isinstance(m, Gauge)
                        else "histogram")
                lines.append(f"# TYPE {name} {kind}")
            if isinstance(m, (Counter, Gauge)):
                lines.append(f"{name}{suffix} {_fmt(m.value)}")
            else:
                cum = 0
                for i, b in enumerate(m.buckets):
                    cum += m.counts[i]
                    lines.append(f"{name}_bucket"
                                 f"{_label_suffix(m.labels, {'le': _fmt(b)})}"
                                 f" {cum}")
                lines.append(f"{name}_bucket"
                             f"{_label_suffix(m.labels, {'le': '+Inf'})}"
                             f" {m.count}")
                lines.append(f"{name}_sum{suffix} {_fmt(round(m.sum, 6))}")
                lines.append(f"{name}_count{suffix} {m.count}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-able snapshot: same information as the text exposition
        plus the deterministic quantile estimates.  Labelled series key
        as ``name{k="v"}``; unlabelled series keep the bare name."""
        out: dict[str, dict] = {"counters": {}, "gauges": {},
                                "histograms": {}}
        for (name, suffix) in sorted(self._metrics):
            m = self._metrics[(name, suffix)]
            if isinstance(m, Counter):
                out["counters"][name + suffix] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name + suffix] = m.value
            else:
                out["histograms"][name + suffix] = m.snapshot()
        return out


# ============================================================== event log


class EventLog:
    """Bounded structured log of trace events with a queryable read side.

    Subscribed to a ``Tracer`` it records every event at emission
    (surviving ring overflow).  ``query`` is the read contract: filter
    by ``kind``, ``rid`` (request id in the payload), and a tick window
    (``tick`` payload key, falling back to the tracer clock stamp), with
    an optional result ``limit`` (most recent wins).  ``dumps``/``dump``
    export JSONL, one event per line, in emission order.
    """

    def __init__(self, capacity: int = 65536):
        self._events: deque[dict] = deque(maxlen=capacity)

    def append(self, ev: TraceEvent) -> None:
        self._events.append(ev.to_dict())

    def __len__(self) -> int:
        return len(self._events)

    def records(self) -> list[dict]:
        """The retained payload dicts in emission order (the timeline
        layer's event-source contract)."""
        return list(self._events)

    @staticmethod
    def _tick(rec: dict) -> float:
        return rec.get("tick", rec.get("t", 0.0))

    def query(self, *, kind: str | None = None, rid: int | None = None,
              tick_min: float | None = None, tick_max: float | None = None,
              limit: int | None = None) -> list[dict]:
        out = [rec for rec in self._events
               if (kind is None or rec.get("kind") == kind)
               and (rid is None or rec.get("rid") == rid)
               and (tick_min is None or self._tick(rec) >= tick_min)
               and (tick_max is None or self._tick(rec) <= tick_max)]
        if limit is not None and limit >= 0:
            out = out[-limit:]
        return out

    def dumps(self, **filters: Any) -> str:
        recs = self.query(**filters) if filters else list(self._events)
        return "".join(json.dumps(r, sort_keys=True) + "\n" for r in recs)

    def dump(self, path) -> int:
        from pathlib import Path
        recs = list(self._events)
        Path(path).write_text(
            "".join(json.dumps(r, sort_keys=True) + "\n" for r in recs))
        return len(recs)


def query_jsonl(lines: Iterable[str], **filters: Any) -> list[dict]:
    """The same read-side contract over an exported JSONL stream (file
    lines), so dumped logs answer the queries the live log does."""
    log = EventLog(capacity=2 ** 31 - 1)
    for line in lines:
        line = line.strip()
        if line:
            rec = json.loads(line)
            log._events.append(rec)
    return log.query(**filters)


# ========================================================== serve binding


class ServeMetrics:
    """Tracer-event → metrics binding for the serving engines.

    ``attach(tracer)`` subscribes ``on_event``; every lifecycle event the
    engines emit updates counters/gauges/histograms live.  All values
    observed are tick-clock payloads (``ttft_ticks``, ``tick``,
    ``pages_in_use``), so the whole registry — quantiles included — is a
    deterministic function of the trace.

    ``labels`` scopes every series this binding creates (e.g.
    ``{"replica": "0"}``): a cluster attaches one ``ServeMetrics`` per
    replica tracer to a *shared* registry, and the single ``/metrics``
    endpoint exposes replica-labelled series side by side.
    """

    def __init__(self, registry: MetricsRegistry | None = None,
                 labels: dict[str, str] | None = None):
        self.registry = registry or MetricsRegistry()
        self.labels = dict(labels or {})
        r, lb = self.registry, self.labels
        self.submitted = r.counter(
            "serve_requests_submitted_total", "requests entering submit()",
            labels=lb)
        self.finished = r.counter(
            "serve_requests_finished_total", "requests run to completion",
            labels=lb)
        self.cancelled = r.counter(
            "serve_requests_cancelled_total", "requests cancelled mid-flight",
            labels=lb)
        self.preemptions = r.counter(
            "serve_preemptions_total", "slots preempted on OOM", labels=lb)
        self.recompiles = r.counter(
            "serve_recompiles_total", "jitted-step compile cache misses",
            labels=lb)
        self.tokens_out = r.counter(
            "serve_tokens_out_total", "output tokens produced", labels=lb)
        self.prefill_tokens = r.counter(
            "serve_prefill_tokens_total", "prompt tokens computed", labels=lb)
        self.cached_tokens = r.counter(
            "serve_cached_tokens_total", "prompt tokens served by prefix cache",
            labels=lb)
        self.steps = r.counter(
            "serve_steps_total", "engine ticks with at least one active lane",
            labels=lb)
        self.routed = r.counter(
            "serve_routed_total", "requests placed by the cluster router",
            labels=lb)
        self.routed_affine = r.counter(
            "serve_routed_affine_total",
            "router placements on a deepest-prefix-match replica", labels=lb)
        self.routed_spill = r.counter(
            "serve_routed_spill_total",
            "router placements spilled off a saturated affine replica",
            labels=lb)
        self.swap_out_pages = r.counter(
            "serve_swap_out_pages_total",
            "KV pages parked on the host swap tier (preempt + prefix "
            "spill)", labels=lb)
        self.swap_in_pages = r.counter(
            "serve_swap_in_pages_total",
            "KV pages restored from the host swap tier (readmit + prefix "
            "page-in)", labels=lb)
        self.host_pages = r.gauge(
            "serve_host_pages_in_use", "host swap tier pages resident",
            labels=lb)
        self.active_lanes = r.gauge(
            "serve_active_lanes", "lanes active in the latest step", labels=lb)
        self.pages_total = r.gauge(
            "serve_pages_total", "page-pool capacity (engine-init)", labels=lb)
        self.prefix_hit_rate = r.gauge(
            "serve_prefix_hit_rate", "cached / (cached + prefill) tokens",
            labels=lb)
        self.ttft = r.histogram(
            "serve_ttft_ticks", "submit-to-first-token latency (tick clock)",
            buckets=TTFT_BUCKETS, labels=lb)
        self.gap = r.histogram(
            "serve_decode_gap_ticks",
            "mean inter-token gap per finished request (tick clock)",
            buckets=GAP_BUCKETS, labels=lb)
        self.occupancy = r.histogram(
            "serve_page_occupancy", "pages in use / pool capacity, sampled "
            "at admission and release", buckets=OCCUPANCY_BUCKETS, labels=lb)
        self._first_tick: dict[int, float] = {}   # rid -> first-token tick
        self._pages = 0

    # ------------------------------------------------------------- attach
    def attach(self, tracer: Tracer) -> Callable[[TraceEvent], None]:
        return tracer.subscribe(self.on_event)

    def _observe_pages(self, data: dict) -> None:
        if self._pages and "pages_in_use" in data:
            self.occupancy.observe(data["pages_in_use"] / self._pages)

    def on_event(self, ev: TraceEvent) -> None:
        d = ev.data
        if ev.kind == "submit":
            self.submitted.inc()
        elif ev.kind == "engine-init":
            self._pages = d.get("pages", 0)
            self.pages_total.set(self._pages)
        elif ev.kind == "admit":
            cached = d.get("cached_tokens", 0)
            if cached:
                self.cached_tokens.inc(cached)
                self._update_hit_rate()
            self._observe_pages(d)
        elif ev.kind == "first-token":
            if "ttft_ticks" in d:
                self.ttft.observe(d["ttft_ticks"])
            if "rid" in d and "tick" in d:
                self._first_tick.setdefault(d["rid"], d["tick"])
        elif ev.kind == "step":
            self.steps.inc()
            self.active_lanes.set(d.get("lanes", 0))
            if d.get("prefill_tokens"):
                self.prefill_tokens.inc(d["prefill_tokens"])
                self._update_hit_rate()
        elif ev.kind == "finish":
            self.finished.inc()
            n = d.get("tokens_out", 0)
            self.tokens_out.inc(n)
            first = self._first_tick.pop(d.get("rid"), None)
            if first is not None and "tick" in d:
                self.gap.observe((d["tick"] - first) / max(n - 1, 1))
            self._observe_pages(d)
        elif ev.kind == "cancel":
            self.cancelled.inc()
            self._first_tick.pop(d.get("rid"), None)
            self._observe_pages(d)
        elif ev.kind == "preempt":
            self.preemptions.inc()
            self._observe_pages(d)
        elif ev.kind == "swap-out":
            self.swap_out_pages.inc(d.get("pages", 0))
            self.host_pages.set(d.get("host_pages_in_use", 0))
            self._observe_pages(d)
        elif ev.kind == "swap-in":
            self.swap_in_pages.inc(d.get("pages", 0))
            self.host_pages.set(d.get("host_pages_in_use", 0))
            self._observe_pages(d)
        elif ev.kind == "compile":
            self.recompiles.inc()
        elif ev.kind == "route":
            self.routed.inc()
            if d.get("decision") in ("affine", "spill"):
                # spill is still a router *decision* series; affinity
                # conversion is the affine counter alone
                (self.routed_affine if d["decision"] == "affine"
                 else self.routed_spill).inc()

    def _update_hit_rate(self) -> None:
        total = self.cached_tokens.value + self.prefill_tokens.value
        if total:
            self.prefix_hit_rate.set(self.cached_tokens.value / total)

    def observe_report(self, report: dict) -> None:
        """Fold an engine report's exact lifetime counters in (the
        subscription sees events; the report carries counters the trace
        does not itemise, e.g. prefill token totals)."""
        if "prefill_tokens" in report:
            delta = report["prefill_tokens"] - self.prefill_tokens.value
            if delta > 0:
                self.prefill_tokens.inc(delta)
            self._update_hit_rate()


# ============================================================ http server


class MetricsServer:
    """Stdlib HTTP exposition of a registry + event log.

    ``handle(path)`` is the entire routing contract as a pure function —
    ``(status, content_type, body)`` — so tests drive every endpoint
    without a socket.  ``serve(port)`` binds a ``ThreadingHTTPServer``
    around it in a daemon thread for real deployments.
    """

    def __init__(self, registry: MetricsRegistry,
                 log: EventLog | None = None):
        self.registry = registry
        self.log = log
        self._httpd = None
        self._thread = None

    # ------------------------------------------------------------ routing
    def handle(self, path: str) -> tuple[int, str, bytes]:
        url = urlsplit(path)
        q = parse_qs(url.query)
        route = url.path.rstrip("/") or "/"
        if route == "/healthz":
            return 200, "application/json", b'{"ok": true}\n'
        if route == "/metrics":
            if q.get("format", [""])[0] == "json":
                return self._json_snapshot()
            body = self.registry.render_prometheus().encode()
            return 200, "text/plain; version=0.0.4", body
        if route == "/metrics.json":
            return self._json_snapshot()
        if route == "/events":
            if self.log is None:
                return 404, "text/plain", b"no event log attached\n"
            try:
                filters: dict[str, Any] = {}
                if "kind" in q:
                    filters["kind"] = q["kind"][0]
                if "rid" in q:
                    filters["rid"] = int(q["rid"][0])
                if "tick_min" in q:
                    filters["tick_min"] = float(q["tick_min"][0])
                if "tick_max" in q:
                    filters["tick_max"] = float(q["tick_max"][0])
                if "limit" in q:
                    filters["limit"] = int(q["limit"][0])
            except ValueError as e:
                return 400, "text/plain", f"bad query: {e}\n".encode()
            body = self.log.dumps(**filters).encode()
            return 200, "application/x-ndjson", body
        if route == "/timeline":
            if self.log is None:
                return 404, "text/plain", b"no event log attached\n"
            body = chrome_trace_bytes(build_timelines(self.log))
            return 200, "application/json", body
        if route.startswith("/requests/"):
            if self.log is None:
                return 404, "text/plain", b"no event log attached\n"
            try:
                rid = int(route.rsplit("/", 1)[1])
            except ValueError:
                return 400, "text/plain", b"bad request id\n"
            recs = self.log.query(rid=rid)
            if not recs:
                return (404, "text/plain",
                        f"no events for rid {rid}\n".encode())
            tl = build_timelines(recs).get(rid)
            # strip the wall-clock stamp so the body, like /metrics, is a
            # deterministic function of the tick-clock trace
            doc = {"rid": rid,
                   "events": [{k: v for k, v in r.items() if k != "t"}
                              for r in recs],
                   "timeline": None if tl is None else tl.describe()}
            body = (json.dumps(doc, sort_keys=True, indent=1) + "\n").encode()
            return 200, "application/json", body
        return 404, "text/plain", f"unknown path {route!r}\n".encode()

    def _json_snapshot(self) -> tuple[int, str, bytes]:
        body = (json.dumps(self.registry.snapshot(), sort_keys=True,
                           indent=1) + "\n").encode()
        return 200, "application/json", body

    # ------------------------------------------------------------ binding
    def serve(self, port: int = 0, host: str = "127.0.0.1") -> int:
        """Bind and serve in a daemon thread; returns the bound port
        (``port=0`` picks an ephemeral one)."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - stdlib contract
                status, ctype, body = outer.handle(self.path)
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # noqa: ARG002 - silence stderr
                pass

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    @property
    def port(self) -> int | None:
        return self._httpd.server_address[1] if self._httpd else None

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._thread = None
