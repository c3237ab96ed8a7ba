"""Runtime audit pipeline of the port: trace what the hot paths did, check
it against what they should have done on this (arch, mesh, workload), and
track performance across runs.  Each module is a copy of the reference's
(``tests/test_torch_copies.py`` holds them equal by text):

  trace        — structured event tracer (ring buffer + scoped spans) the
                 engines, scheduler and launchers emit into
  expectations — pathway-expectation registry; mismatches become
                 diagnostics findings
  ledger       — per-benchmark perf ledger with baselines, regression
                 thresholds and orphan-file auditing
  metrics      — live serving observability: a Tracer-fed registry, a
                 queryable event log and the ``MetricsServer`` endpoint
  timeline     — per-request phase timelines, p99-TTFT attribution and a
                 Chrome-trace exporter
  report       — ``RunAudit``: folds the evidence into
                 ``core.diagnostics.Diagnostics``, whose ``gate()`` drives
                 a launcher's exit code
"""
from repro_torch.audit.expectations import (DEFAULT_REGISTRY, AuditContext,
                                            Evidence, ExpectationRegistry,
                                            ExpectedSignature, Rule,
                                            nearest_rank)
from repro_torch.audit.ledger import Ledger, LedgerResult, MetricSpec
from repro_torch.audit.metrics import (EventLog, MetricsRegistry,
                                       MetricsServer, ServeMetrics,
                                       query_jsonl)
from repro_torch.audit.report import RunAudit
from repro_torch.audit.timeline import (PHASES, RequestTimeline, Span,
                                        attribution, build_timelines,
                                        chrome_trace_bytes, to_chrome_trace)
from repro_torch.audit.trace import (KNOWN_KINDS, NULL_TRACER, TraceEvent,
                                     Tracer)

__all__ = [
    "AuditContext", "DEFAULT_REGISTRY", "EventLog", "Evidence",
    "ExpectationRegistry", "ExpectedSignature", "KNOWN_KINDS", "Ledger",
    "LedgerResult", "MetricSpec", "MetricsRegistry", "MetricsServer",
    "NULL_TRACER", "PHASES", "RequestTimeline", "Rule", "RunAudit",
    "ServeMetrics", "Span", "TraceEvent", "Tracer", "attribution",
    "build_timelines", "chrome_trace_bytes", "nearest_rank", "query_jsonl",
    "to_chrome_trace",
]
