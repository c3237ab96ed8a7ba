"""Persisted perf ledger: per-benchmark baselines with regression gates.

One ``BENCH_<name>.json`` file per benchmark (the repo's benchmark
artifact convention) holding the baseline metric values plus a bounded
history of runs.  Semantics:

  * first run on a site writes the baseline (an ``info`` finding records
    that no comparison happened);
  * later runs compare each gated metric against the baseline with a
    per-metric relative threshold and direction (throughput regressing
    ≥20% is an ``error``; latency metrics invert the sign);
  * noisy wall-clock metrics can be recorded ungated (``gate=False``) so
    the trajectory is tracked without flaking CI — deterministic
    counters (decode steps, cached tokens, hit rates) carry the tight
    thresholds instead.

This is the BENCH trajectory ROADMAP asks for: the ledger files live
next to the repo (gitignored) on dev machines and in the artifact store
on CI, so "performance-verified" means verified against *this site's*
own history, the paper's per-site attestation model.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Sequence

LEDGER_VERSION = 1
HISTORY_KEEP = 50


@dataclass(frozen=True)
class MetricSpec:
    """How one metric is judged.  ``rel_tol`` is the allowed relative
    move in the *bad* direction (0.2 = 20%); ``higher_is_better`` sets
    which direction is bad; ``gate=False`` records without judging."""

    name: str
    higher_is_better: bool = True
    rel_tol: float = 0.2
    gate: bool = True


@dataclass
class LedgerResult:
    bench: str
    baseline_written: bool = False
    deltas: dict = field(default_factory=dict)    # metric -> delta record
    findings: list[dict] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not any(f["severity"] == "error" for f in self.findings)


class Ledger:
    """Baseline store rooted at a directory of ``BENCH_*.json`` files."""

    def __init__(self, root: str | Path):
        self.root = Path(root)

    def path(self, bench: str) -> Path:
        safe = "".join(c if (c.isalnum() or c in "-_") else "_"
                       for c in bench)
        return self.root / f"BENCH_{safe}.json"

    # ------------------------------------------------------------- state
    def load(self, bench: str) -> dict | None:
        p = self.path(bench)
        if not p.exists():
            return None
        try:
            return json.loads(p.read_text())
        except (json.JSONDecodeError, OSError):
            return None

    def baseline(self, bench: str) -> dict[str, float] | None:
        rec = self.load(bench)
        return rec.get("baseline") if rec else None

    def _write(self, bench: str, rec: dict) -> None:
        self.root.mkdir(parents=True, exist_ok=True)
        self.path(bench).write_text(json.dumps(rec, indent=1, sort_keys=True))

    # --------------------------------------------------------- integrity
    def scan(self) -> list[Path]:
        """Every ``BENCH_*.json`` under the root, sorted by name."""
        return sorted(self.root.glob("BENCH_*.json"))

    def audit_owned(self, owned: Sequence[str]) -> list[dict]:
        """Flag ledger files no registered benchmark owns.

        A ``BENCH_*.json`` whose ``bench`` name (the record field, or the
        filename stem for unparseable files) is not in ``owned`` is a
        stale artifact: either its benchmark was deleted without its
        ledger, or the file was written by code that never landed.
        Orphans are ``error`` findings — a baseline nobody maintains is
        worse than none, because it silently attests metrics nothing
        measures anymore."""
        owned_set = set(owned)
        out: list[dict] = []
        for p in self.scan():
            rec = None
            try:
                rec = json.loads(p.read_text())
            except (json.JSONDecodeError, OSError):
                pass
            name = (rec or {}).get("bench") or p.stem[len("BENCH_"):]
            if name not in owned_set:
                out.append({
                    "severity": "error", "kind": "ledger-orphan",
                    "detail": f"{p.name}: ledger for {name!r} has no "
                              f"registered benchmark owner (known: "
                              f"{sorted(owned_set)}); delete the file or "
                              f"register the benchmark",
                })
        return out

    def rolling_median(self, bench: str, metric: str,
                       window: int = 9) -> dict | None:
        """Median of ``metric`` over the last ``window`` history entries.

        Noisy wall-clock metrics (tracked ungated) are unreadable run to
        run on a shared machine; the rolling median over ledger history
        is the trajectory signal.  Returns ``{median, n, latest}`` or
        ``None`` when no history entry carries the metric."""
        rec = self.load(bench)
        if not rec:
            return None
        vals = [h["metrics"][metric] for h in rec.get("history", [])
                if metric in h.get("metrics", {})][-window:]
        if not vals:
            return None
        ordered = sorted(vals)
        mid = len(ordered) // 2
        med = (ordered[mid] if len(ordered) % 2
               else (ordered[mid - 1] + ordered[mid]) / 2.0)
        return {"median": round(med, 4), "n": len(vals),
                "latest": vals[-1]}

    # ----------------------------------------------------------- compare
    def compare(self, bench: str, metrics: dict[str, float],
                specs: Sequence[MetricSpec], *,
                update_baseline: bool = False) -> LedgerResult:
        """Judge ``metrics`` against the stored baseline and append to the
        run history.  Missing baseline (or ``update_baseline=True``)
        (re)writes it.  Metrics absent from the baseline are added to it
        without judgement (new metrics must not fail old ledgers)."""
        res = LedgerResult(bench=bench)
        rec = self.load(bench) or {
            "version": LEDGER_VERSION, "bench": bench,
            "baseline": None, "history": [],
        }
        by_name = {s.name: s for s in specs}
        base = rec.get("baseline")

        if base is None or update_baseline:
            rec["baseline"] = dict(metrics)
            res.baseline_written = True
            res.findings.append({
                "severity": "info", "kind": "ledger-baseline",
                "detail": f"{bench}: baseline "
                          f"{'rewritten' if base is not None else 'written'} "
                          f"({len(metrics)} metric(s)); no comparison run",
            })
        else:
            for name, cur in metrics.items():
                spec = by_name.get(name, MetricSpec(name, gate=False))
                if name not in base:
                    base[name] = cur     # adopt new metrics silently
                    continue
                ref = base[name]
                # zero baseline: judge against the current value instead
                # so a move away from 0 still registers (a 0-baseline must
                # not blind the gate forever)
                denom = abs(ref) if ref else max(abs(cur), 1e-12)
                rel = (cur - ref) / denom
                # loss = relative move in the bad direction (positive=worse)
                loss = -rel if spec.higher_is_better else rel
                status = "ok"
                if spec.gate and loss > spec.rel_tol:
                    status = "regression"
                    res.findings.append({
                        "severity": "error", "kind": "perf-regression",
                        "detail": f"{bench}.{name}: {cur:g} vs baseline "
                                  f"{ref:g} ({100 * rel:+.1f}%, tolerance "
                                  f"{100 * spec.rel_tol:.0f}% "
                                  f"{'drop' if spec.higher_is_better else 'rise'})",
                    })
                elif spec.gate and -loss > spec.rel_tol:
                    status = "improvement"
                    res.findings.append({
                        "severity": "info", "kind": "perf-improvement",
                        "detail": f"{bench}.{name}: {cur:g} vs baseline "
                                  f"{ref:g} ({100 * rel:+.1f}%) — consider "
                                  f"--update-baseline to ratchet",
                    })
                res.deltas[name] = {
                    "baseline": ref, "current": cur,
                    "rel_change": round(rel, 4), "status": status,
                    "gated": spec.gate,
                }

        rec["history"] = (rec.get("history", [])
                          + [{"t": time.time(), "metrics": dict(metrics)}]
                          )[-HISTORY_KEEP:]
        self._write(bench, rec)
        return res
