"""Ring-network construction (Arbor ring benchmark + NEURON ringtest).

Port of ``repro.neuro.ring``.  Arbor's benchmark: N cable cells in a
unidirectional ring, cell i receives one excitatory synapse from cell i-1
(mod N) with a fixed axonal delay; an external stimulus kicks cell 0 and
the action potential propagates around the ring.  NEURON's ringtest: R
independent rings (chains) of cells.

Both are one object: ``RingConfig(n_cells, n_rings)`` — with n_rings=1 it
is the Arbor ring; with n_rings=R the cells split into R independent rings
(cell -> cell+1 within its ring).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.neuro.cable import CellConfig


@dataclass(frozen=True)
class RingConfig:
    n_cells: int = 512
    n_rings: int = 1
    delay_ms: float = 5.0            # axonal delay = BSP exchange epoch
    t_end_ms: float = 40.0
    stim_ms: float = 3.0             # stimulus duration into each ring head
    stim_current: float = 20.0
    cell: CellConfig = field(default_factory=CellConfig)

    @property
    def cells_per_ring(self) -> int:
        assert self.n_cells % self.n_rings == 0
        return self.n_cells // self.n_rings

    @property
    def delay_steps(self) -> int:
        return max(int(round(self.delay_ms / self.cell.dt)), 1)

    @property
    def n_epochs(self) -> int:
        total_steps = int(round(self.t_end_ms / self.cell.dt))
        return max(total_steps // self.delay_steps, 1)


def source_of(cfg: RingConfig,
              device: str | torch.device = "cpu") -> torch.Tensor:
    """Global presynaptic source id for every cell (ring wiring), int64."""
    ids = torch.arange(cfg.n_cells, device=device)
    ring = ids // cfg.cells_per_ring
    pos = ids % cfg.cells_per_ring
    prev_pos = (pos - 1) % cfg.cells_per_ring
    return ring * cfg.cells_per_ring + prev_pos


def is_ring_head(cfg: RingConfig,
                 device: str | torch.device = "cpu") -> torch.Tensor:
    """Cells that receive the external stimulus (cell 0 of each ring)."""
    return (torch.arange(cfg.n_cells, device=device)
            % cfg.cells_per_ring) == 0
