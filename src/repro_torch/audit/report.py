"""Fold runtime audit evidence into the CI diagnostics gate.

``RunAudit`` is the one object a launcher or benchmark needs: it owns
the tracer the instrumented layers emit into, evaluates the expectation
registry over the collected evidence, runs the perf ledger comparison,
and folds everything into a ``core.diagnostics.Diagnostics`` whose
``gate()`` drives the process exit code.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

from repro_torch.audit.expectations import (DEFAULT_REGISTRY, AuditContext,
                                            Evidence, ExpectationRegistry)
from repro_torch.audit.ledger import Ledger, LedgerResult, MetricSpec
from repro_torch.audit.trace import Tracer
from repro_torch.core.diagnostics import Diagnostics
from repro_torch.core.inspector import TransportReport


@dataclass
class RunAudit:
    """One audited run: create it with the workload context, hand
    ``tracer`` to the engine/scheduler/launcher, then call ``finish``."""

    ctx: AuditContext
    # a fresh copy of the default rules per audit: register() on one
    # RunAudit's registry must not leak into every later audit in the
    # process
    registry: ExpectationRegistry = field(
        default_factory=lambda: ExpectationRegistry(DEFAULT_REGISTRY.rules))
    capacity: int = 4096
    tracer: Tracer = field(init=False)
    last_ledger: LedgerResult | None = field(default=None, init=False)

    def __post_init__(self):
        self.tracer = Tracer(capacity=self.capacity)

    # ---------------------------------------------------------- evaluate
    def evaluate(self, *, engine_report: dict | None = None,
                 transport: TransportReport | None = None) -> list[dict]:
        """Expectation mismatches only (no ledger), as raw findings."""
        ev = Evidence(tracer=self.tracer, engine_report=engine_report,
                      transport=transport)
        return self.registry.evaluate(self.ctx, ev)

    def finish(self, diag: Diagnostics | None = None, *,
               engine_report: dict | None = None,
               transport: TransportReport | None = None,
               ledger: Ledger | None = None,
               bench: str | None = None,
               metrics: dict[str, float] | None = None,
               specs: Sequence[MetricSpec] = (),
               update_baseline: bool = False,
               source: str = "audit") -> Diagnostics:
        """Evaluate expectations (+ ledger when given) into ``diag``."""
        diag = diag or Diagnostics()
        diag.extend(self.evaluate(engine_report=engine_report,
                                  transport=transport), source=source)
        if ledger is not None and bench is not None and metrics:
            self.last_ledger = ledger.compare(
                bench, metrics, specs, update_baseline=update_baseline)
            diag.extend(self.last_ledger.findings, source=f"{source}-ledger")
        return diag

    # ----------------------------------------------------------- summary
    def summary(self, diag: Diagnostics | None = None) -> dict:
        out = {
            "context": {
                "workload": self.ctx.workload, "family": self.ctx.family,
                "arch": self.ctx.arch, "mesh": list(self.ctx.mesh),
                "shared_prefix": self.ctx.shared_prefix,
            },
            "trace": self.tracer.summary(),
            "rules_matched": [r.name for r in self.registry.match(self.ctx)],
        }
        if self.last_ledger is not None:
            out["ledger"] = {
                "bench": self.last_ledger.bench,
                "baseline_written": self.last_ledger.baseline_written,
                "deltas": self.last_ledger.deltas,
            }
        if diag is not None:
            out["findings"] = diag.findings
            out["worst"] = diag.worst
            out["gate_ok"] = diag.gate()
        return out
