"""Bulk-synchronous ring simulation (Arbor's execution model).

Port of ``repro.neuro.sim``.  Arbor advances all cells independently for
one min-delay window, then exchanges the generated spikes with a global
MPI_Allgather (§6.2.1 of the paper).  Here:

  MPI rank            -> a rank of a 1-D ``DeviceMesh`` (its ``cells``
                         axis); rank r holds cells [r*n_loc, (r+1)*n_loc)
  local cell update   -> one ``kernels.ops.cable_epoch`` call an epoch on
                         the rank's cells: on a card one launch of the epoch
                         kernel, every cell through all the epoch's dt steps
                         with its state on chip (the reference's inner
                         ``lax.scan``); on the CPU its plain version
  MPI_Allgather       -> ``torch.distributed.all_gather`` of the epoch's
                         int8 spike matrix [steps, n_loc], in rank order, to
                         [steps, N]; each cell takes its source's column
  axonal delay        -> the exchange epoch length (spikes generated in
                         epoch k are applied in epoch k+1)

Epochs are a Python loop over device tensors (the reference's outer
``lax.scan``).  Nothing is read back to the host inside it: the spike
counts accumulate on the device, each epoch's furthest spiking global id is
stacked there, and one ``all_reduce(MAX)`` of the stack after the last
epoch gives what the reference's per-epoch ``pmax`` gives.  Tensors go to
the group's backend as they lie: NCCL moves device tensors on the device,
gloo (ranks sharing a card) through host memory inside the op, which the
attested program names (``core.attest``).  ``mesh=None`` is one device and
no collective.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

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
    state: cable.CellState       # every cell's


def _all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t``, in rank order, joined along ``dim``."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class Shard:
    """One rank's cells of the ring, ``[start, start + n_loc)``, with the
    wiring and stimulus they take and the group their spikes are exchanged
    over (``None``: one device holds every cell)."""

    def __init__(self, cfg: RingConfig, device: torch.device,
                 mesh: DeviceMesh | None = None, axis: str = "cells"):
        if mesh is None:
            self.group, rank, size = None, 0, 1
        else:
            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a 1-D DeviceMesh, not "
                                f"{type(mesh).__name__}")
            if mesh.ndim != 1 or mesh.mesh_dim_names != (axis,):
                raise ValueError(
                    f"simulate shards cells over a 1-D mesh named "
                    f"({axis!r},); got {mesh.mesh_dim_names} of shape "
                    f"{tuple(mesh.shape)}")
            self.group = mesh.get_group(axis)
            rank, size = mesh.get_local_rank(axis), mesh.size()
            if cfg.n_cells % size:
                raise ValueError(f"{cfg.n_cells} cells do not split evenly "
                                 f"over {size} ranks")
        self.cfg = cfg
        self.n_loc = cfg.n_cells // size
        self.start = rank * self.n_loc
        cells = slice(self.start, self.start + self.n_loc)
        self.sources = source_of(cfg, device)[cells]   # global ids
        self.ids = torch.arange(self.start, self.start + self.n_loc,
                                dtype=torch.int32, device=device)
        self.i_stim = (is_ring_head(cfg, device)[cells].float()
                       * cfg.stim_current)
        self.stim_steps = int(round(cfg.stim_ms / cfg.cell.dt))

    def epoch(self, state: cable.CellState, incoming: torch.Tensor,
              index: int) -> tuple[cable.CellState, torch.Tensor,
                                   torch.Tensor]:
        """Epoch ``index`` on this rank's cells: (new state, the spikes
        arriving in the next epoch [steps, n_loc] fp32, this epoch's spikes
        [steps, n_loc] bool).  One ``cable_epoch`` call and, over a mesh,
        one all-gather of ``steps * N`` int8 bytes; nothing else moves."""
        steps = self.cfg.delay_steps
        # the epoch's steps that still take the stimulus
        stim_left = min(max(self.stim_steps - index * steps, 0), steps)
        state, spiked = kops.cable_epoch(state, self.cfg.cell, incoming,
                                         self.i_stim, stim_left)
        # spikes travel as int8 (the paper's MPI_Allgather moves compact
        # spike records too): 4x less exchange traffic than f32 flags
        spikes = spiked.to(torch.int8)
        if self.group is not None:
            spikes = _all_gather(spikes, self.group, dim=1)   # [steps, N]
        return state, spikes[:, self.sources].float(), spiked


def run(cfg: RingConfig, state: cable.CellState, device: torch.device,
        mesh: DeviceMesh | None = None, axis: str = "cells"
        ) -> tuple[cable.CellState, torch.Tensor, torch.Tensor]:
    """All epochs from this rank's ``state``, the loop ``simulate`` times:
    (its final state, its cells' spike counts [n_loc] int32, the global
    wavefront [n_epochs] int32), all on ``device`` and nothing read
    back."""
    shard = Shard(cfg, device, mesh, axis)
    incoming = torch.zeros((cfg.delay_steps, shard.n_loc),
                           dtype=torch.float32, device=device)
    counts = torch.zeros(shard.n_loc, dtype=torch.int32, device=device)
    no_front = torch.full_like(shard.ids, -1)
    fronts = []
    for epoch in range(cfg.n_epochs):
        state, incoming, spiked = shard.epoch(state, incoming, epoch)
        counts += spiked.sum(dim=0, dtype=torch.int32)
        fronts.append(torch.where(spiked.any(dim=0), shard.ids,
                                  no_front).max())
    fronts = torch.stack(fronts)
    if shard.group is not None:
        dist.all_reduce(fronts, op=dist.ReduceOp.MAX, group=shard.group)
    return state, counts, fronts


def simulate(cfg: RingConfig, *, device: str | torch.device = "cuda",
             mesh: DeviceMesh | None = None, axis: str = "cells"
             ) -> SimResult:
    """Run the ring network on ``device`` ("cuda" unless the caller asks
    for "cpu"; raises when CUDA is asked for and absent).  ``mesh``: a 1-D
    ``DeviceMesh`` named ``axis`` to shard the cells over (``n_cells`` must
    split evenly; every rank calls this), ``None`` for one device.  The run
    is made twice from the same initial state and the second is timed, as
    the reference times its run after the one that compiles it: from a
    barrier to the read of the rank's total.  The global counts and state
    are gathered after the timed window."""
    dev = resolve_device(device)
    shard = Shard(cfg, dev, mesh, axis)
    state0 = cable.init_state(shard.n_loc, cfg.cell, dev)
    run(cfg, state0, dev, mesh, axis)   # warm: kernel build, allocator
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if shard.group is not None:
        dist.barrier(group=shard.group)
    t0 = time.perf_counter()
    state, counts, fronts = run(cfg, state0, dev, mesh, axis)
    total = int(counts.sum())           # the run's one read-back
    wall = time.perf_counter() - t0
    if shard.group is not None:
        counts = _all_gather(counts, shard.group, dim=0)
        state = cable.CellState(*(_all_gather(t, shard.group, dim=0)
                                  for t in state))
        total = int(counts.sum())
    return SimResult(spike_counts=counts, total_spikes=total,
                     wavefront=fronts, wall_s=wall, state=state)
