"""Rank processes for ``tests/test_torch_distributed.py``.

``run_ranks`` starts one spawned process a rank, each wired up through
``core.bootstrap.init_distributed`` over gloo on the CPU with a ``file://``
rendezvous under the caller's directory (never a TCP port, so parallel
test workers cannot collide), each with one intra-op thread and a timeout
of its own.  Every rank runs ``rank_main`` and saves what it saw to
``rank<r>.pt``; the test process reads those files and holds them against
the reference.  This module imports torch and the port only: JAX stays in
the test process.
"""
from __future__ import annotations

import datetime
import multiprocessing
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs.base import MeshConfig
from repro_torch.core import attest
from repro_torch.core.bootstrap import (WireUp, init_benchmark,
                                        init_distributed)
from repro_torch.launch.mesh import make_mesh
from repro_torch.neuro import cable, sim
from repro_torch.neuro.ring import RingConfig
from repro_torch.parallel import RULESETS, bind, mesh_of, sharding_for

TIMEOUT_S = 120
# tests/test_neuro.py's distributed ring
RING = dict(n_cells=32, t_end_ms=30.0,
            cell=cable.CellConfig(n_compartments=4))
# (logical axes, shape) read through a real (2, 2) mesh at world size 4
MESH_CASES = [(("embed", "mlp"), (64, 256)),
              (("act_batch", "act_seq", "act_embed"), (1, 64, 128)),
              (("act_seq", "act_batch"), (8, 8)),
              (("vocab", "embed"), (3, 128))]


def _raises(fn) -> str | None:
    """The message of the ``ValueError`` ``fn`` raises, ``None`` if none."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def rank_main(rank: int, world: int, directory: str) -> None:
    torch.set_num_threads(1)
    out: dict = {}
    try:
        init_distributed(WireUp("localhost:0", world, rank), "cpu",
                         backend="gloo",
                         init_method=f"file://{directory}/store",
                         timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            cfg = RingConfig(**RING)
            mesh = mesh_of((world,), ("cells",), "cpu")
            res = sim.simulate(cfg, device="cpu", mesh=mesh)
            out["ring"] = {"counts": res.spike_counts,
                           "wavefront": res.wavefront,
                           "total": res.total_spikes, "wall_s": res.wall_s,
                           "state": tuple(res.state)}
            # one sharded epoch, recorded
            shard = sim.Shard(cfg, torch.device("cpu"), mesh)
            state = cable.init_state(shard.n_loc, cfg.cell)
            incoming = torch.zeros(cfg.delay_steps, shard.n_loc)
            with attest.record() as program:
                shard.epoch(state, incoming, 0)
            report = attest.parse_program(program.text, world)
            out["epoch"] = {"lines": program.lines,
                            "ops": [(op.kind, op.payload_bytes)
                                    for op in report.ops],
                            "findings": report.findings}
            out["uneven"] = _raises(lambda: sim.simulate(
                RingConfig(**{**RING, "n_cells": 33}), device="cpu",
                mesh=mesh))
            out["mismatch"] = _raises(lambda: make_mesh(
                MeshConfig((2 * world,), ("cells",)), device="cpu"))
            if world == 4:
                m = make_mesh(MeshConfig((2, 2), ("data", "model")),
                              device="cpu")
                out["mesh22"] = {"shape": tuple(m.shape),
                                 "names": m.mesh_dim_names,
                                 "coordinate": m.get_coordinate()}
                out["two_axes"] = _raises(lambda: sim.simulate(
                    cfg, device="cpu", mesh=m))
                with bind(m, RULESETS["train"]) as ctx:
                    out["mesh22"]["cases"] = [
                        (ctx.resolve(logical, shape),
                         [str(p) for p in sharding_for(logical, shape)])
                        for logical, shape in MESH_CASES]
            if world == 1:
                out["init_benchmark"] = init_benchmark(
                    (1, 1), ("data", "model"), repeats=1, device="cpu")
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except Exception:                  # reported to the test, then raised
        out["error"] = traceback.format_exc()
        raise
    finally:
        torch.save(out, Path(directory) / f"rank{rank}.pt")


def run_ranks(worlds: tuple[int, ...], directory: Path
              ) -> dict[int, list[dict]]:
    """Run ``rank_main`` at each world size in ``worlds``, all at once, in
    spawned processes (a rendezvous directory a world); each world's
    results, in rank order.  Fails if any rank fails or outlives
    TIMEOUT_S."""
    ctx = multiprocessing.get_context("spawn")
    procs = {}
    for world in worlds:
        (directory / str(world)).mkdir()
        procs[world] = [ctx.Process(target=rank_main,
                                    args=(r, world, str(directory / str(world))))
                        for r in range(world)]
    every = [p for ps in procs.values() for p in ps]
    for p in every:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p in every:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        for p in every:
            if p.is_alive():
                p.kill()
                p.join()
    results, errors = {}, []
    for world, ps in procs.items():
        results[world] = []
        for r, p in enumerate(ps):
            path = directory / str(world) / f"rank{r}.pt"
            res = torch.load(path) if path.exists() else {}
            if p.exitcode != 0 or "error" in res:
                errors.append((world, r, p.exitcode, res.get("error")))
            results[world].append(res)
    assert not errors, errors
    return results
