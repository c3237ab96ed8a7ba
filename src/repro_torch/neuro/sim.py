"""Bulk-synchronous ring simulation (Arbor's execution model), one device.

Port of ``repro.neuro.sim``.  Arbor advances all cells independently for
one min-delay window, then exchanges the generated spikes with a global
MPI_Allgather (§6.2.1 of the paper).  Here, on one device:

  local cell update   -> one ``kernels.ops.cable_epoch`` call an epoch:
                         on a card one launch of the epoch kernel, every
                         cell through all the epoch's dt steps with its
                         state on chip (the reference's inner
                         ``lax.scan``); on the CPU its plain version, a
                         loop of the cable step
  spike exchange      -> the epoch's int8 spike matrix indexed by each
                         cell's presynaptic source
  axonal delay        -> the exchange epoch length (spikes generated in
                         epoch k are applied in epoch k+1)

Epochs are a Python loop over device tensors (the reference's outer
``lax.scan``).  Nothing is read back to the host inside it: the spike
counts accumulate on the device and the epochs' wavefronts are stacked
there and read once at the end.  The sharded form (cells split over a
mesh, ``all_gather`` of the spike matrix, ``pmax`` of the front) waits for
the port's multi-GPU slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.kernels import ops as kops
from repro_torch.neuro import cable
from repro_torch.neuro.ring import RingConfig, is_ring_head, source_of
from repro_torch.serve.engine import resolve_device


@dataclass
class SimResult:
    spike_counts: torch.Tensor   # [N] int32 — spikes per cell
    total_spikes: int
    wavefront: torch.Tensor      # [n_epochs] int32 — furthest spiking cell
    wall_s: float
    state: cable.CellState


def run(cfg: RingConfig, state: cable.CellState, device: torch.device
        ) -> tuple[cable.CellState, torch.Tensor, torch.Tensor]:
    """All epochs from ``state``, the loop ``simulate`` times: (final
    state, spike counts [N] int32, wavefront [n_epochs] int32), all on
    ``device`` and nothing read back."""
    n = cfg.n_cells
    steps, dt = cfg.delay_steps, cfg.cell.dt
    stim_steps = int(round(cfg.stim_ms / dt))
    sources = source_of(cfg, device)
    ids = torch.arange(n, dtype=torch.int32, device=device)
    no_front = torch.full_like(ids, -1)
    i_stim = is_ring_head(cfg, device).float() * cfg.stim_current
    incoming = torch.zeros((steps, n), dtype=torch.float32, device=device)
    counts = torch.zeros(n, dtype=torch.int32, device=device)
    fronts = []
    for epoch in range(cfg.n_epochs):
        # the epoch's steps that still take the stimulus
        stim_left = min(max(stim_steps - epoch * steps, 0), steps)
        state, spiked = kops.cable_epoch(state, cfg.cell, incoming, i_stim,
                                         stim_left)
        # spikes travel as int8 (the paper's MPI_Allgather moves compact
        # spike records too); each cell takes its source's column
        incoming = spiked.to(torch.int8)[:, sources].float()
        counts += spiked.sum(dim=0, dtype=torch.int32)
        fronts.append(torch.where(spiked.any(dim=0), ids, no_front).max())
    return state, counts, torch.stack(fronts)


def simulate(cfg: RingConfig, *, device: str | torch.device = "cuda",
             mesh=None) -> SimResult:
    """Run the ring network on one device ("cuda" unless the caller asks
    for "cpu"; raises when CUDA is asked for and absent).  The run is made
    twice from the same initial state and the second is timed, as the
    reference times its run after the one that compiles it."""
    if mesh is not None:
        raise NotImplementedError(
            "simulate over a mesh (cells sharded, all_gather of the spike "
            "matrix) waits for the port's multi-GPU slice; pass mesh=None")
    dev = resolve_device(device)
    state0 = cable.init_state(cfg.n_cells, cfg.cell, dev)
    run(cfg, state0, dev)               # warm: kernel build, allocator
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    state, counts, fronts = run(cfg, state0, dev)
    total = int(counts.sum())           # the run's one read-back
    wall = time.perf_counter() - t0
    return SimResult(spike_counts=counts, total_spikes=total,
                     wavefront=fronts, wall_s=wall, state=state)
