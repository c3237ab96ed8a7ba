"""Single-GPU training launcher.

Port of ``repro.launch.train`` on one device, in the reference's order:
wire-up (the PMIx analogue, ``core.bootstrap``) → manifest capture and
host binding (``core.manifest``) → data pipeline → train step, the first
step attested (``core.attest``: its dispatched program fingerprinted, its
transport report judged by ``RunAudit``) → checkpoint/restart loop with
straggler tracking, traced as ``train-step``, ``ckpt-save`` and
``ckpt-restore`` events.  ``manifest.json`` and ``result.json`` land in
``--out``: the bound manifest is written before the loop, as the
reference writes its own, so that a resumed run with no step left has one
too, and written again with the program once the first step is attested.
Runs on the GPU unless ``--device cpu`` is given, and raises where CUDA is
asked for and absent:

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
        --steps 4 [--device cpu] [--resume --out DIR]

Any arch of the dense, moe, ssm and hybrid families trains
(``granite-moe-1b-a400m``, ``qwen3-moe-30b-a3b``, ``mamba2-2.7b``,
``zamba2-2.7b``); on a card attention runs the flash kernel and the scans
the SSD kernel.  The vlm and encdec archs (``llama-3.2-vision-11b``,
``whisper-medium``) are refused: their batches carry image or audio
embeddings, and the data pipeline yields tokens and labels only, as the
reference's does (its launcher fails on the missing embeddings).  They
train through ``Model.loss`` and ``train.step.make_train_step`` on batches
from ``Model.sample_batch``.

One device, so the mesh is ``TINY_MESH`` and ``--production-mesh`` is
refused: the production mesh belongs to the multi-GPU slice.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.audit import AuditContext, RunAudit
from repro_torch.configs import TINY_MESH
from repro_torch.configs.base import (RunConfig, ShapeConfig, TrainConfig,
                                      reduced)
from repro_torch.core import attest
from repro_torch.core.bootstrap import WireUp, init_distributed
from repro_torch.core.diagnostics import Diagnostics
from repro_torch.core.manifest import Manifest, PortableEnv
from repro_torch.core.registry import resolve_arch
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.models import build
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.straggler import StragglerTracker
from repro_torch.serve.engine import resolve_device
from repro_torch.train.step import init_train_state, make_train_step

DEFAULT_OUT = str(Path(tempfile.gettempdir()) / "repro_torch_train")
# the families whose batches need more than the pipeline's tokens and labels
MISSING_EMBEDS = {"vlm": "image_embed", "encdec": "audio_embed"}


def train(arch: str, *, smoke: bool = True, steps: int = 20,
          seq_len: int = 128, global_batch: int = 8, ckpt_every: int = 10,
          out_dir: str = DEFAULT_OUT, production_mesh: bool = False,
          resume: bool = False, seed: int = 0,
          total_steps: int | None = None, device: str = "cuda") -> dict:
    """Train ``arch`` (its ``reduced()`` form when ``smoke``) for ``steps``
    steps, checkpointing every ``ckpt_every``; ``resume`` continues from
    the latest checkpoint in ``out_dir``."""
    if production_mesh:
        raise ValueError("the production mesh belongs to the multi-GPU "
                         "slice of the port; this launcher runs one device")
    cfg = reduced(resolve_arch(arch)) if smoke else resolve_arch(arch)
    embeds = MISSING_EMBEDS.get(cfg.family)
    if embeds:
        raise ValueError(
            f"{cfg.name} ({cfg.family}) trains on {embeds}, which the data "
            f"pipeline does not yield (tokens and labels only); train it "
            f"through Model.loss on Model.sample_batch batches")
    dev = resolve_device(device)
    wireup = init_distributed(WireUp.from_env(), dev)
    shape = ShapeConfig("train", "train", seq_len, global_batch)
    horizon = total_steps or steps  # LR schedule horizon: fixed across
    # restarts so a resumed run follows the identical schedule
    tc = TrainConfig(total_steps=horizon, warmup_steps=max(horizon // 10, 1),
                     remat="full", seed=seed)
    run = RunConfig(model=cfg, shape=shape, train=tc)
    model = build(cfg)
    manifest = Manifest(PortableEnv.capture(cfg, shape, tc, run.rules)).bind(
        dev, TINY_MESH)

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "manifest.json").write_text(manifest.to_json())
    ckpt = CheckpointManager(out / "ckpt")
    diag = Diagnostics()
    audit = RunAudit(AuditContext(workload="train", family=cfg.family,
                                  arch=cfg.name, mesh=TINY_MESH.shape))
    tracer = audit.tracer
    step_fn = make_train_step(model, run)

    start_step = 0
    state = init_train_state(
        model, torch.Generator(device=dev).manual_seed(seed), dev)
    if resume and ckpt.latest_step() is not None:
        start_step = ckpt.latest_step()
        state = ckpt.restore(start_step, like=state)
        tracer.emit("ckpt-restore", step=start_step)
        print(f"[train] resumed from step {start_step}")

    data = DataPipeline(
        DataConfig(cfg.vocab_size, seq_len, global_batch, seed=seed,
                   n_hosts=wireup.num_processes, host_id=wireup.process_id),
        start_step=start_step)
    tracker = StragglerTracker(n_hosts=wireup.num_processes)
    report = None
    losses = []
    t_start = time.time()
    try:
        for _ in range(start_step, steps):
            step_id, host_batch = next(data)
            batch = {k: torch.tensor(a, device=dev)
                     for k, a in host_batch.items()}
            first = report is None
            t0 = time.perf_counter()
            with tracer.span("train-step", step=step_id) as ev:
                # the first step is attested: the program it dispatches
                with (attest.record() if first
                      else contextlib.nullcontext()) as program:
                    state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
                ev["loss"] = loss
            dt = time.perf_counter() - t0
            tracker.observe({wireup.process_id: dt})
            if first:
                report = attest.parse_program(program.text,
                                              TINY_MESH.n_devices)
                manifest.attest(program_text=program.text,
                                collectives=report.summary())
                diag.extend(report.findings, "train-step-program")
                (out / "manifest.json").write_text(manifest.to_json())
            losses.append(loss)
            if (step_id + 1) % ckpt_every == 0 or step_id + 1 == steps:
                with tracer.span("ckpt-save", step=step_id + 1):
                    ckpt.save(step_id + 1, state,
                              extra={"loss": loss,
                                     "image_hash":
                                     manifest.portable.image_hash})
    finally:
        data.close()
    # pathway expectations over the attested transport report: the same
    # program the manifest records is judged against what this (family,
    # mesh, workload) should emit
    audit.finish(diag, transport=report, source="train-audit")

    result = {
        "arch": cfg.name,
        "steps": steps,
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "loss_decreased": bool(losses and losses[-1] < losses[0]),
        "wall_s": round(time.time() - t_start, 2),
        "fleet_efficiency": tracker.fleet_efficiency(),
        "diagnostics": diag.worst,
        "audit": {"trace": tracer.summary()["counts"],
                  "findings": diag.findings, "gate_ok": diag.gate()},
        "image_hash": manifest.portable.image_hash,
        "wireup": vars(wireup),
        "device": str(dev),
        "losses": losses,
    }
    (out / "result.json").write_text(json.dumps(result, indent=1))
    return result


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    res = train(args.arch, smoke=args.smoke, steps=args.steps,
                seq_len=args.seq_len, global_batch=args.global_batch,
                ckpt_every=args.ckpt_every, out_dir=args.out,
                resume=args.resume, production_mesh=args.production_mesh,
                device=args.device)
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
