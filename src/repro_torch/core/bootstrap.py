"""Distributed wire-up: the PMIx analogue, on ``torch.distributed``.

In the paper, containerized MPI ranks resolve endpoints by querying the
host's Slurm-side PMIx server; the container carries its own complete MPI
stack and only the wire-up protocol crosses the boundary.  Here each host
process knows only (coordinator_address, num_processes, process_id), the
exact PMIx triple, and hands it to ``torch.distributed.init_process_group``
(NCCL on the card, gloo on the CPU).

This module provides:
  * WireUp — the reference's (``repro.core.bootstrap``), copied verbatim
    and held equal by text in ``tests/test_torch_env.py``;
  * init_distributed() — binds it (no-op single-process unless a backend
    is named, ``init_process_group`` otherwise);
  * init_benchmark() — the ``osu_init`` analogue: wall-clock of mesh
    construction, the first collective (under NCCL it sets up the
    communicator, which NCCL does lazily) and steady collectives, the
    costs the paper measures in Fig. 1.
"""
from __future__ import annotations

import datetime
import os
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist


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


def _ranks_on_node(w: WireUp) -> int | None:
    """How many of the job's ranks share this node: Slurm's tasks a node
    where Slurm says so, every rank when the coordinator is this host,
    unknown otherwise."""
    per_node = os.environ.get("SLURM_NTASKS_PER_NODE")   # "4" or "4(x2)"
    if per_node:
        return int(per_node.split("(")[0].split(",")[0])
    if w.coordinator.rsplit(":", 1)[0] in ("localhost", "127.0.0.1"):
        return w.num_processes
    return None


def init_distributed(wireup: WireUp | None = None,
                     device: str | torch.device = "cuda", *,
                     backend: str | None = None,
                     init_method: str | None = None,
                     timeout: datetime.timedelta | None = None) -> WireUp:
    """Bind the process into the cluster.  The process group takes NCCL
    for a CUDA ``device`` and gloo for the CPU, unless ``backend`` names
    one: ranks that share a card ask for gloo, since NCCL takes one rank a
    device.  Single-process: no-op, unless ``backend`` is named, which
    makes a group of one (NCCL's calls then run for real).
    ``init_method`` defaults to ``tcp://`` the coordinator; ``timeout``
    bounds the rendezvous and every collective."""
    w = wireup or WireUp.from_env()
    if not (w.is_distributed or backend):
        return w
    backend = backend or ("nccl" if torch.device(device).type == "cuda"
                          else "gloo")
    if backend == "nccl":
        local = _ranks_on_node(w)
        cards = torch.cuda.device_count()
        if local is not None and local > cards:
            raise ValueError(
                f"NCCL takes one rank a device: {local} ranks on this node "
                f"but {cards} CUDA device(s); ranks that share a card ask "
                f"for backend='gloo'")
    kw = {"backend": backend,
          "init_method": init_method or f"tcp://{w.coordinator}",
          "world_size": w.num_processes, "rank": w.process_id}
    if timeout is not None:
        kw["timeout"] = timeout
    dist.init_process_group(**kw)
    return w


def init_benchmark(mesh_shape: tuple[int, ...], axes: tuple[str, ...],
                   repeats: int = 3, *, device: str = "cuda") -> dict:
    """osu_init analogue: time the runtime's transition to a communicable
    state over the process group that stands: (1) mesh construction,
    (2) the first collective, an ``all_reduce`` of an ``[n*128]`` f32
    tensor over the first axis (under NCCL it sets up the communicator,
    the transport's endpoints), (3) steady-state collective issue, min and
    max over ``repeats``.  Each collective is synchronized before its
    clock stops."""
    from repro_torch.parallel.ctx import mesh_of
    from repro_torch.serve.engine import resolve_device

    dev = resolve_device(device)
    out: dict = {"mesh_shape": mesh_shape, "axes": axes}

    t0 = time.perf_counter()
    mesh = mesh_of(mesh_shape, axes, dev.type)
    out["mesh_construct_s"] = time.perf_counter() - t0

    n = mesh.size()
    x = torch.arange(n * 128, dtype=torch.float32, device=dev)
    group = mesh.get_group(axes[0])

    def collective() -> float:
        t0 = time.perf_counter()
        dist.all_reduce(x, group=group)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    out["first_collective_s"] = collective()
    times = [collective() for _ in range(repeats)]
    out["steady_collective_s"] = min(times)
    out["steady_collective_max_s"] = max(times)
    return out
