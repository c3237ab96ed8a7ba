"""Straggler mitigation for the synchronous training loop: the port's own
copy of ``repro.runtime.straggler`` (pure numpy; copied, not imported, so
the port never loads the JAX package).

At pod scale the step time is the MAX over hosts; persistent stragglers
(thermals, failing HBM, noisy neighbours on shared fabric) drag the fleet.
Two mitigations, both standard in large production runs:

  * detection — per-host step-time EWMA vs fleet median; a host whose
    EWMA exceeds ``threshold`` × median for ``patience`` consecutive steps
    is flagged (and fed to the health registry / reallocation policy);
  * data-path absorption — the input pipeline keeps a prefetch depth of
    ``bound`` steps per host, so transient stalls (GC, filesystem hiccups)
    do not propagate into the collective; the tracker reports how much of
    the budget each host consumes.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np


@dataclass
class StragglerTracker:
    n_hosts: int
    alpha: float = 0.2          # EWMA coefficient
    threshold: float = 1.5      # × fleet median
    patience: int = 5
    ewma: dict[int, float] = field(default_factory=dict)
    strikes: dict[int, int] = field(default_factory=lambda: defaultdict(int))

    def observe(self, step_times: dict[int, float]) -> list[int]:
        """Record one step's per-host wall times; returns flagged hosts."""
        for h, t in step_times.items():
            prev = self.ewma.get(h, t)
            self.ewma[h] = (1 - self.alpha) * prev + self.alpha * t
        med = float(np.median(list(self.ewma.values())))
        flagged = []
        for h, e in self.ewma.items():
            if e > self.threshold * med:
                self.strikes[h] += 1
                if self.strikes[h] >= self.patience:
                    flagged.append(h)
            else:
                self.strikes[h] = 0
        return flagged

    def fleet_efficiency(self) -> float:
        """median/max of EWMAs — the fraction of sync-step time that is
        fleet-wide useful (1.0 = no straggling)."""
        if not self.ewma:
            return 1.0
        vals = list(self.ewma.values())
        return float(np.median(vals) / max(max(vals), 1e-12))
