"""Dual-environment verification harness.

The port's own copy of ``repro.core.verify`` (numpy only), held equal to
it by ``tests/test_torch_gather.py``.

The paper's method: run the identical benchmark natively and inside the
container; agreement within noise bands *is* the portability proof, and
divergence localizes misconfiguration (in either environment — §8 found
host-side regressions this way).

Here an "environment" is any way of executing the same workload: the
plain PyTorch version vs the CUDA kernel, the gather pathway vs the paged
one, the contiguous engine vs the paged engine, or commit N vs commit N+1.
The harness runs both, compares numerics and timing with the paper's
statistics (mean ± min/max error bars, relative agreement bands), and
emits machine-checkable verdicts that CI can gate on.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np


@dataclass
class EnvResult:
    name: str
    wall_times: list[float] = field(default_factory=list)
    value: Any = None

    @property
    def mean(self) -> float:
        return float(np.mean(self.wall_times)) if self.wall_times else float("nan")

    @property
    def std(self) -> float:
        return float(np.std(self.wall_times)) if self.wall_times else float("nan")

    @property
    def vmin(self) -> float:
        return float(np.min(self.wall_times)) if self.wall_times else float("nan")

    @property
    def vmax(self) -> float:
        return float(np.max(self.wall_times)) if self.wall_times else float("nan")


@dataclass
class Verdict:
    kind: str          # numeric | timing
    ok: bool
    detail: str
    measured: float
    bound: float


@dataclass
class DualEnvReport:
    a: EnvResult
    b: EnvResult
    verdicts: list[Verdict] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(v.ok for v in self.verdicts)

    def summary(self) -> dict:
        return {
            "a": {"name": self.a.name, "mean_s": self.a.mean,
                  "min_s": self.a.vmin, "max_s": self.a.vmax},
            "b": {"name": self.b.name, "mean_s": self.b.mean,
                  "min_s": self.b.vmin, "max_s": self.b.vmax},
            "overhead_pct": 100.0 * (self.b.mean - self.a.mean)
                            / max(self.a.mean, 1e-12),
            "verdicts": [vars(v) for v in self.verdicts],
            "ok": self.ok,
        }


class DualEnvHarness:
    """Run one workload under two environments and compare.

    ``workload(env_fn) -> value`` where env_fn is the environment's
    callable; numeric agreement uses ``np.allclose``-style relative bands
    (the paper's NCCL runs agreed to 0.01–1.3 %; kernels vs oracles must
    agree to fp tolerance), timing agreement uses a relative overhead band
    (the paper tolerates a constant 12–19 % only when it does not grow
    with scale — callers check that with two harness runs at two scales).
    """

    def __init__(self, *, repeats: int = 3, warmup: int = 1):
        self.repeats = repeats
        self.warmup = warmup

    def _run(self, name: str, fn: Callable[[], Any]) -> EnvResult:
        res = EnvResult(name=name)
        for _ in range(self.warmup):
            res.value = fn()
        for _ in range(self.repeats):
            t0 = time.perf_counter()
            res.value = fn()
            res.wall_times.append(time.perf_counter() - t0)
        return res

    def compare(self, name_a: str, fn_a: Callable[[], Any],
                name_b: str, fn_b: Callable[[], Any], *,
                rtol: float = 2e-2, atol: float = 1e-5,
                timing_band: float | None = None) -> DualEnvReport:
        a = self._run(name_a, fn_a)
        b = self._run(name_b, fn_b)
        report = DualEnvReport(a=a, b=b)

        if a.value is not None and b.value is not None:
            va = np.asarray(a.value, dtype=np.float64)
            vb = np.asarray(b.value, dtype=np.float64)
            if va.shape == vb.shape:
                denom = np.maximum(np.abs(va), atol)
                rel = float(np.max(np.abs(va - vb) / denom))
                report.verdicts.append(Verdict(
                    kind="numeric", ok=bool(rel <= rtol),
                    detail=f"max rel err {rel:.3e} vs band {rtol:.1e}",
                    measured=rel, bound=rtol))
            else:
                report.verdicts.append(Verdict(
                    kind="numeric", ok=False,
                    detail=f"shape mismatch {va.shape} vs {vb.shape}",
                    measured=float("nan"), bound=rtol))

        if timing_band is not None and a.mean > 0:
            over = (b.mean - a.mean) / a.mean
            report.verdicts.append(Verdict(
                kind="timing", ok=bool(over <= timing_band),
                detail=f"overhead {100*over:.1f}% vs band {100*timing_band:.0f}%",
                measured=over, bound=timing_band))
        return report


def constant_vs_scaling_overhead(overheads: dict[int, float],
                                 tol: float = 0.5) -> str:
    """Classify an overhead curve the way the paper does for GPU-Arbor
    (§6.2.3): a constant relative overhead is a per-launch cost
    (acceptable); one growing with scale is a communication penalty (a
    pathway misconfiguration).  ``overheads``: scale -> relative overhead."""
    if len(overheads) < 2:
        return "insufficient-data"
    scales = sorted(overheads)
    lo, hi = overheads[scales[0]], overheads[scales[-1]]
    if abs(lo) < 0.02 and abs(hi) < 0.02:
        return "negligible"
    if lo <= 0 or hi <= 0:
        return "noise-dominated"
    growth = hi / max(lo, 1e-9)
    if growth < 1 + tol and growth > 1 / (1 + tol):
        return "constant-overhead"
    return "scaling-overhead"
