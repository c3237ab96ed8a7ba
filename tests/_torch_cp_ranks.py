"""Rank processes for ``tests/test_torch_context_parallel.py``.

As ``_torch_tp_ranks`` (whose step, ``run_case``, this module reuses): the
test process writes ``inputs.npz`` (``draw_inputs``) and starts one spawned
process a rank for each world size at once (``start``), each wired up over
gloo on the CPU through a ``file://`` rendezvous under its world's
directory, with one intra-op thread and a deadline of its own, and
``destroy_process_group`` in ``finally``.  Every rank runs its world's
cases (``WORLD_CASES``) and saves what it saw to ``rank<r>.pt``;
``_torch_tp_ranks.join`` reads them back.  This module imports torch and
the port only.
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import _torch_tp_ranks as T
from repro_torch.configs import ALL_ARCHS, reduced
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core.bootstrap import WireUp, init_distributed
from repro_torch.launch import bind as B
from repro_torch.models import params as P
from repro_torch.models.model import Model
from repro_torch.models.ssm import conv_channels, mamba_block_cp
from repro_torch.optim import adamw
from repro_torch.parallel import RULESETS, bind, comm, mesh_of
from repro_torch.parallel.ctx import _current
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.train.step import TrainState, make_train_step

TIMEOUT_S = T.TIMEOUT_S
SEQ, BATCH, TC, AXES = T.SEQ, T.BATCH, T.TC, T.AXES
CONFIGS = {
    "ssm": dataclasses.replace(reduced(ALL_ARCHS["mamba2-2.7b"]),
                               n_layers=2),
    # two groups, each a Mamba2 layer and the shared attention block
    "hybrid": reduced(ALL_ARCHS["zamba2-2.7b"]),
}
# world size -> (config, mesh shape, dtype) a case; hybrid at (2, 2) writes
# the checkpoint that world 2 restores at (1, 2)
WORLD_CASES = {
    2: [("ssm", (1, 2), "float32"), ("ssm", (2, 1), "float32"),
        ("hybrid", (1, 2), "float32"), ("hybrid", (2, 1), "float32")],
    4: [("ssm", (1, 4), "float32"), ("ssm", (2, 2), "float32"),
        ("hybrid", (1, 4), "float32"), ("hybrid", (2, 2), "float32")],
    8: [("ssm", (2, 2, 2), "bfloat16"), ("hybrid", (2, 2, 2), "bfloat16")],
}
# at (1, 4): 18 tokens a rank, no multiple of the scan chunk min(16, 18)
REFUSED_SEQ = 72


# ------------------------------------------------------------------ inputs


def draw_inputs(path: Path, seed: int = 0) -> None:
    """``_torch_tp_ranks.draw_inputs``'s scheme over ``CONFIGS``, with
    ``a_log`` drawn as ``log(uniform(0.02, 0.1))``: decays of about
    ``exp(-0.1)`` a token, so one rank's final state still reaches the
    next rank's outputs (at ``a_log`` near 1 it would vanish within a few
    tokens, and a wrong prefix would pass).  Also the block's input ``x``
    and the cotangents of its output, conv tail and final state, scaled
    as a mean's (by ``1 / (B * S)`` and ``1 / B``), so the gradients are
    of order one and f32's rounding of them stays under 2e-5."""
    rng = np.random.default_rng(seed)
    out: dict[str, np.ndarray] = {}
    for name, cfg in CONFIGS.items():
        for key, spec in T._flat(Model(cfg).param_specs()).items():
            if key.endswith("a_log"):
                a = np.log(rng.uniform(0.02, 0.1, spec.shape))
            elif spec.init in ("ones", "zeros"):
                a = 1.0 + 0.1 * rng.standard_normal(spec.shape)
            else:
                fan = (spec.shape[-1] if spec.init == "embed" else int(
                    np.prod([n for n, ax in zip(spec.shape[:-1], spec.axes)
                             if ax not in ("layers", "groups")]) or 1))
                a = rng.standard_normal(spec.shape) * fan ** -0.5
            out[f"{name}/{key}"] = a.astype(np.float32)
    cfg = CONFIGS["ssm"]
    for i in ("", "2"):
        toks = rng.integers(0, cfg.vocab_size, size=(BATCH, SEQ + 1))
        out["tokens" + i] = toks[:, :-1].astype(np.int32)
        out["labels" + i] = toks[:, 1:].astype(np.int32)
    shapes = {"x": (BATCH, SEQ, cfg.d_model), "gy": (BATCH, SEQ, cfg.d_model),
              "g_tail": (BATCH, cfg.conv_width - 1, conv_channels(cfg)),
              "g_state": (BATCH, cfg.n_ssm_heads, cfg.ssm_head_dim,
                          cfg.ssm_state)}
    scale = {"x": 1.0, "gy": 1.0 / (BATCH * SEQ)}
    for key, shape in shapes.items():
        out[key] = (rng.standard_normal(shape)
                    * scale.get(key, 1.0 / BATCH)).astype(np.float32)
    np.savez(path, **out)


def load(path: Path, name: str, dtype: str = "float32"):
    """(params, batch, batch2) of config ``name`` as full CPU tensors,
    params in ``dtype`` but for the f32 ones of the spec."""
    data = np.load(path)
    specs = T._flat(Model(CONFIGS[name]).param_specs())
    params = T._nest({k: torch.from_numpy(data[f"{name}/{k}"]).to(
        torch.float32 if s.dtype == torch.float32 else getattr(torch, dtype))
        for k, s in specs.items()})
    batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "labels")}
    batch2 = {k: torch.from_numpy(data[k + "2"])
              for k in ("tokens", "labels")}
    return params, batch, batch2


def run_case(name: str, params: dict, batch: dict, mesh=None,
             record: bool = False) -> dict:
    return T.run_case(name, params, batch, mesh, record, cfg=CONFIGS[name])


# ------------------------------------------------------------------- cases


def _block(directory: Path) -> dict:
    """``mamba_block_cp`` with ``return_state`` on layer 0 of the ssm
    config (``P.whole`` of this rank's shards) and this rank's shard of
    ``x``: y, the conv tail and the final state, and the gradients of
    ``sum(y * gy) + sum(tail * g_tail) + sum(state * g_state)`` in every
    parameter and in ``x``, gathered.  The replicated outputs' terms count
    on model rank 0 only, so the ranks' parts sum to the loss once."""
    ctx = _current()
    cfg = CONFIGS["ssm"]
    data = np.load(directory / "inputs.npz")
    params, _, _ = load(directory / "inputs.npz", "ssm")
    specs = Model(cfg).param_specs()["layers"]["mamba"]
    local = P.tree_map(lambda t: t[0].clone().requires_grad_(True),
                       B.shard(params["layers"]["mamba"],
                               P.partition(specs)))
    res = ctx.resolve(("act_batch", "act_res", None), (BATCH, SEQ, 1))
    x = ctx.shard(torch.from_numpy(data["x"]), res).requires_grad_(True)
    y, (tail, state) = mamba_block_cp(
        cfg, P.whole(local, specs, stacked=True), x, return_state=True)
    # every rank takes the replicated outputs into its loss (so every
    # rank's backward joins their all-gathers' reduce-scatters), weighted 0
    # but on model rank 0
    lead = float(ctx.coordinate(("model",)) == 0)
    loss = ((y * ctx.shard(torch.from_numpy(data["gy"]), res)).sum()
            + lead * (tail * torch.from_numpy(data["g_tail"])).sum()
            + lead * (state * torch.from_numpy(data["g_state"])).sum())
    loss.backward()
    grads = P.tree_map2(
        lambda t, spec: ctx.unshard(t.grad, ctx.resolve(spec.axes,
                                                        spec.shape)[1:]),
        local, specs)
    return {"y": ctx.unshard(y.detach(), res), "tail": tail.detach(),
            "state": state.detach(), "grads": grads,
            "dx": ctx.unshard(x.grad, res)}


def _shift() -> dict:
    """``comm.shift`` over the model axis of a bf16 tensor that holds this
    rank's index, and its gradient under the weight ``10 + rank``."""
    ctx = _current()
    me = ctx.coordinate(("model",))
    x = torch.full((2, 3, 5), float(me + 1), dtype=torch.bfloat16,
                   requires_grad=True)
    y = comm.shift(x, ctx.group(("model",)))
    (y.float() * (10.0 + me)).sum().backward()
    return {"y": y.detach(), "grad": x.grad}


def _refusals() -> dict:
    """What ``mamba_block_cp`` and each family's loss raise at
    ``REFUSED_SEQ`` tokens on the bound mesh."""
    out = {}
    for fam, arch in (("ssm", "mamba2-2.7b"), ("hybrid", "zamba2-2.7b")):
        out[fam] = T._refusal(arch, REFUSED_SEQ)
    ctx = _current()
    cfg = CONFIGS["ssm"]
    tp = ctx.axis_sizes["model"]
    p = P.initialize(Model(cfg).param_specs()["layers"]["mamba"],
                     torch.Generator().manual_seed(0), "cpu")
    p = P.tree_map(lambda t: t[0], p)
    try:
        mamba_block_cp(cfg, p, torch.zeros(1, REFUSED_SEQ // tp,
                                           cfg.d_model, dtype=torch.bfloat16))
        out["block"] = None
    except ValueError as e:
        out["block"] = str(e)
    return out


def _next_loss(name: str, state: TrainState, batch: dict, mesh) -> float:
    model = Model(CONFIGS[name])
    shape = ShapeConfig("t", "train", SEQ, BATCH)
    step = make_train_step(model, RunConfig(model.cfg, shape, TC,
                                            rules="train"))
    _, metrics = step(state, B.shard_batch(model, shape, mesh, batch))
    return float(metrics["loss"])


def _restore_step(directory: Path, mesh) -> float:
    """The loss of the step after the hybrid checkpoint that world 4 wrote
    at (2, 2), restored onto ``mesh``."""
    ckpt = directory.parent / "ckpt"
    deadline = time.monotonic() + TIMEOUT_S
    while not (ckpt / "step_00000001").is_dir():
        if time.monotonic() > deadline:
            raise TimeoutError("no checkpoint from the (2, 2) mesh")
        time.sleep(0.2)
    params, _, batch2 = load(directory / "inputs.npz", "hybrid")
    s_sh = B.state_shardings(Model(CONFIGS["hybrid"]), mesh)
    like = B.shard(TrainState(params, adamw.init(params)), s_sh)
    state = CheckpointManager(ckpt).restore(1, like, shardings=s_sh)
    return _next_loss("hybrid", state, batch2, mesh)


def rank_main(rank: int, world: int, directory: str) -> None:
    torch.set_num_threads(1)
    d = Path(directory)
    out: dict = {}
    try:
        init_distributed(WireUp("localhost:0", world, rank), "cpu",
                         backend="gloo", init_method=f"file://{d}/store",
                         timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            for name, shape, dtype in WORLD_CASES[world]:
                mesh = mesh_of(shape, AXES[len(shape)], "cpu")
                params, batch, batch2 = load(d / "inputs.npz", name, dtype)
                with bind(mesh, RULESETS["train"]):
                    res = run_case(name, params, batch, mesh, record=True)
                    if (name, shape) == ("ssm", (1, 2)):
                        again = run_case(name, params, batch, mesh)
                        res["again"] = {k: again[k] for k in
                                        ("loss", "params", "grads")}
                        res["thread_grads"] = T._backward_elsewhere(
                            name, params, batch, mesh, cfg=CONFIGS[name])
                    if (name, shape) == ("hybrid", (2, 2)):
                        s_sh = B.state_shardings(Model(CONFIGS[name]), mesh)
                        CheckpointManager(d.parent / "ckpt").save(
                            1, res["state"], shardings=s_sh)
                        res["next_loss"] = _next_loss(name, res["state"],
                                                      batch2, mesh)
                    if name == "ssm" and shape[0] == 1:
                        res["block"] = _block(d)
                        res["shift"] = _shift()
                    if shape == (1, 4) and name == "ssm":
                        res["refusals"] = _refusals()
                del res["state"]
                if rank:
                    res = {k: res[k] for k in ("loss", "step_loss",
                                               "grad_norm", "shift")
                           if k in res}
                out[T.case_key(name, shape, dtype)] = res
            if world == 2:
                mesh = mesh_of((1, 2), AXES[2], "cpu")
                with bind(mesh, RULESETS["train"]):
                    out["restored_loss"] = _restore_step(d, mesh)
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except Exception:                  # reported to the test, then raised
        out["error"] = traceback.format_exc()
        raise
    finally:
        torch.save(out, d / f"rank{rank}.pt")


def start(worlds: tuple[int, ...], directory: Path) -> dict:
    """Start every world's ranks at once (a directory a world under
    ``directory``, which holds ``inputs.npz``); ``_torch_tp_ranks.join``
    waits for them."""
    ctx = multiprocessing.get_context("spawn")
    procs = {}
    for world in worlds:
        wdir = directory / f"world{world}"
        wdir.mkdir()
        (wdir / "inputs.npz").symlink_to(directory / "inputs.npz")
        procs[world] = [ctx.Process(target=rank_main,
                                    args=(r, world, str(wdir)))
                        for r in range(world)]
    for ps in procs.values():
        for p in ps:
            p.start()
    return {"procs": procs, "dir": directory,
            "deadline": time.monotonic() + TIMEOUT_S}
