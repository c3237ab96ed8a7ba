"""Findings → reports: severity policy and human/CI rendering.

The paper's outlook (§8) calls for "automated log parsing to proactively
evaluate debug messages, immediately detecting and correcting suboptimal
transport pathways without requiring user intervention."  This module is
that layer: inspector findings + verify verdicts + manifest diffs are
folded into one report with a CI exit policy.
"""
from __future__ import annotations

from dataclasses import dataclass, field

SEVERITY_ORDER = {"info": 0, "warn": 1, "error": 2}


@dataclass
class Diagnostics:
    findings: list[dict] = field(default_factory=list)

    def extend(self, findings: list[dict], source: str) -> None:
        for f in findings:
            self.findings.append({**f, "source": source})

    def add_verdicts(self, verdicts: list, source: str) -> None:
        for v in verdicts:
            if not v.ok:
                self.findings.append({
                    "severity": "error", "kind": f"verify-{v.kind}",
                    "detail": v.detail, "source": source,
                })

    def add_manifest_diff(self, lines: list[str], source: str) -> None:
        for line in lines:
            sev = "warn" if "(host)" in line or "EXPECTED" in line else "error"
            self.findings.append({
                "severity": sev, "kind": "manifest-drift",
                "detail": line, "source": source,
            })

    @property
    def worst(self) -> str:
        if not self.findings:
            return "ok"
        return max((f["severity"] for f in self.findings),
                   key=lambda s: SEVERITY_ORDER.get(s, 0))

    def gate(self, fail_on: str = "error") -> bool:
        """True = pass.  CI calls this; the paper's 'performance-verified
        image' is one whose diagnostics gate passes on every target site."""
        bar = SEVERITY_ORDER.get(fail_on, 2)
        return all(SEVERITY_ORDER.get(f["severity"], 0) < bar
                   for f in self.findings)

    def render(self) -> str:
        if not self.findings:
            return "diagnostics: clean"
        lines = [f"diagnostics: {len(self.findings)} finding(s), worst={self.worst}"]
        for f in sorted(self.findings,
                        key=lambda f: -SEVERITY_ORDER.get(f["severity"], 0)):
            lines.append(f"  [{f['severity']:5s}] {f.get('kind', '?'):24s} "
                         f"({f.get('source', '?')}) {f.get('detail', '')}")
        return "\n".join(lines)
