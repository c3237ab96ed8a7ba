"""Distributed wire-up: the PMIx analogue, on ``torch.distributed``.

In the paper, containerized MPI ranks resolve endpoints by querying the
host's Slurm-side PMIx server; the container carries its own complete MPI
stack and only the wire-up protocol crosses the boundary.  Here each host
process knows only (coordinator_address, num_processes, process_id), the
exact PMIx triple, and hands it to ``torch.distributed.init_process_group``
(NCCL on the card, gloo on the CPU).

``WireUp`` is the reference's (``repro.core.bootstrap``), copied verbatim
and held equal by text in ``tests/test_torch_env.py``.  The reference's
``init_benchmark`` (the ``osu_init`` analogue) times a collective over a
mesh and belongs to the port's multi-GPU slice.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class WireUp:
    coordinator: str
    num_processes: int
    process_id: int
    local_device_count: int | None = None

    @classmethod
    def from_env(cls) -> "WireUp":
        """Resolve the wire-up triple the way srun --mpi=pmix publishes it."""
        if "SLURM_NTASKS" in os.environ and int(os.environ["SLURM_NTASKS"]) > 1:
            nodelist = os.environ.get("SLURM_STEP_NODELIST", "localhost")
            head = nodelist.split(",")[0].split("[")[0]
            port = os.environ.get("REPRO_COORD_PORT", "9876")
            return cls(
                coordinator=f"{head}:{port}",
                num_processes=int(os.environ["SLURM_NTASKS"]),
                process_id=int(os.environ.get("SLURM_PROCID", "0")),
            )
        return cls(coordinator="localhost:9876", num_processes=1, process_id=0)

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1


def init_distributed(wireup: WireUp | None = None,
                     device: str | torch.device = "cuda") -> WireUp:
    """Bind the process into the cluster.  Single-process: no-op.  The
    process group takes NCCL for a CUDA ``device`` and gloo for the CPU."""
    w = wireup or WireUp.from_env()
    if w.is_distributed:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        torch.distributed.init_process_group(
            backend=backend, init_method=f"tcp://{w.coordinator}",
            world_size=w.num_processes, rank=w.process_id)
    return w
