"""Failure detection and the restart protocol (simulated multi-host).

At 1000+ nodes the failure model is: some host stops heartbeating; the job
must (a) notice within a bounded window, (b) decide whether to wait
(transient) or rebuild (hard failure), and (c) restart from the last
committed checkpoint on the surviving mesh (elastic) or on a replacement
allocation.  On a real cluster the heartbeat transport is the coordinator
(jax.distributed) or Slurm's job-step state; here the registry is
process-local and the tests drive it with synthetic clocks — the decision
logic is what matters and is identical.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable


class HostState(Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    DEAD = "dead"


@dataclass
class HostRecord:
    host_id: int
    last_beat: float
    state: HostState = HostState.HEALTHY
    incarnation: int = 0


@dataclass
class HealthRegistry:
    """Phi-accrual-lite failure detector: suspect after ``suspect_s``
    without a heartbeat, dead after ``dead_s``."""

    n_hosts: int
    suspect_s: float = 10.0
    dead_s: float = 60.0
    clock: Callable[[], float] = time.monotonic  # injectable for tests
    hosts: dict[int, HostRecord] = field(default_factory=dict)

    def __post_init__(self):
        now = self.clock()
        for h in range(self.n_hosts):
            self.hosts[h] = HostRecord(h, now)

    def beat(self, host_id: int) -> None:
        rec = self.hosts[host_id]
        if rec.state == HostState.DEAD:
            rec.incarnation += 1  # host came back: new incarnation
        rec.last_beat = self.clock()
        rec.state = HostState.HEALTHY

    def sweep(self) -> dict[int, HostState]:
        now = self.clock()
        for rec in self.hosts.values():
            silence = now - rec.last_beat
            if silence >= self.dead_s:
                rec.state = HostState.DEAD
            elif silence >= self.suspect_s:
                rec.state = HostState.SUSPECT
        return {h: r.state for h, r in self.hosts.items()}

    @property
    def survivors(self) -> list[int]:
        self.sweep()
        return [h for h, r in self.hosts.items() if r.state != HostState.DEAD]

    @property
    def healthy(self) -> bool:
        return len(self.survivors) == self.n_hosts



@dataclass
class RestartPlan:
    """What the controller does after a failure sweep."""

    action: str                 # continue | wait | rebuild
    mesh_hosts: list[int]
    restore_step: int | None = None
    reason: str = ""


def plan_restart(registry: HealthRegistry, last_checkpoint: int | None,
                 min_hosts: int, grace_s: float, silence_s: float) -> RestartPlan:
    """The restart protocol:
      * all healthy               -> continue
      * suspects within grace     -> wait (transient network blips)
      * dead hosts, enough left   -> rebuild elastic mesh from survivors,
                                     restore last checkpoint
      * too few survivors         -> wait for replacement allocation
    """
    states = registry.sweep()
    survivors = [h for h, s in states.items() if s != HostState.DEAD]
    suspects = [h for h, s in states.items() if s == HostState.SUSPECT]
    dead = [h for h, s in states.items() if s == HostState.DEAD]

    if not suspects and not dead:
        return RestartPlan("continue", survivors, reason="all healthy")
    if suspects and not dead and silence_s < grace_s:
        return RestartPlan("wait", survivors,
                           reason=f"suspects {suspects} within grace window")
    if dead and len(survivors) >= min_hosts:
        return RestartPlan("rebuild", survivors, restore_step=last_checkpoint,
                           reason=f"dead {dead}; elastic rebuild on "
                                  f"{len(survivors)} survivors")
    return RestartPlan("wait", survivors,
                       reason=f"only {len(survivors)} survivors < {min_hosts};"
                              " awaiting replacement allocation")
