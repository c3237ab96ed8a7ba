"""Rank processes for ``tests/test_torch_tensor_parallel.py``.

The test process writes ``inputs.npz`` (weights and batches drawn with
numpy, ``draw_inputs``) and starts one spawned process a rank for each
world size at once (``start``), each wired up over gloo on the CPU through
a ``file://`` rendezvous under its world's directory, with one intra-op
thread and a deadline of its own.  Every rank runs its world's cases
(``WORLD_CASES``) and saves what it saw to ``rank<r>.pt``; ``join`` reads
them back.  ``run_case`` is also the one-process step the test holds the
ranks against.  This module imports torch and the port only.
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import time
import traceback
import weakref
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.audit import AuditContext, RunAudit
from repro_torch.configs import ALL_ARCHS, reduced
from repro_torch.configs.base import RunConfig, ShapeConfig, TrainConfig
from repro_torch.core import attest
from repro_torch.core.bootstrap import WireUp, init_distributed
from repro_torch.launch import bind as B
from repro_torch.models import params as P
from repro_torch.models.layers import swiglu
from repro_torch.models.attention import full_attention
from repro_torch.models.model import Model
from repro_torch.models.moe import moe_ffn
from repro_torch.optim import adamw
from repro_torch.parallel import RULESETS, bind, mesh_of
from repro_torch.parallel.ctx import ShardCtx, _current, sharding_for
from repro_torch.runtime import checkpoint as ckpt_mod
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.train.step import TrainState, make_train_step

TIMEOUT_S = 240
SEQ, BATCH = 32, 4
# eps 1e-2 makes the first AdamW step linear in the gradient (with 1e-8 it
# is the gradient's sign, which an element a few ulps from zero flips), so
# the parameters after one step carry the gradients' values
TC = TrainConfig(learning_rate=1e-2, warmup_steps=0, total_steps=10,
                 eps=1e-2, remat="full")
_DENSE = dataclasses.replace(reduced(ALL_ARCHS["deepseek-7b"]), n_layers=2)
_MOE = dataclasses.replace(reduced(ALL_ARCHS["granite-moe-1b-a400m"]),
                           n_layers=2)
CONFIGS = {
    "dense": _DENSE,
    # n_kv * group = 6 does not split 4 ways: g_pad 4 against a group of 3
    "gpad": dataclasses.replace(_DENSE, n_heads=6, n_kv_heads=2),
    "moe": _MOE,
    # nothing drops at this capacity, and the aux (per shard by design)
    # is weighted 0: the sharded step equals the one-process one
    "moe_cf8": dataclasses.replace(_MOE, capacity_factor=8.0,
                                   router_aux_weight=0.0),
}
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
# world size -> (config, mesh shape, dtype) a case; the first dense case of
# world 4 writes the checkpoint that world 2 restores
WORLD_CASES = {
    2: [("dense", (1, 2), "float32"), ("dense", (2, 1), "float32"),
        ("moe", (1, 2), "float32"), ("moe", (2, 1), "float32"),
        ("moe_cf8", (1, 2), "float32")],
    4: [("dense", (2, 2), "float32"), ("gpad", (1, 4), "float32"),
        ("moe", (2, 2), "float32"), ("moe_cf8", (2, 2), "float32")],
    8: [("dense", (2, 2, 2), "bfloat16"), ("moe", (2, 2, 2), "bfloat16")],
}
REFUSED = {"ssm": "mamba2-2.7b", "hybrid": "zamba2-2.7b",
           "vlm": "llama-3.2-vision-11b", "encdec": "whisper-medium"}
# ssm and hybrid run under a model axis through the context-parallel block;
# they refuse a sequence outside its condition: at (1, 2), 24 tokens a rank
# are no multiple of the scan chunk min(16, 24)
REFUSED_SEQ = {"ssm": 48, "hybrid": 48}


def case_key(name: str, shape: tuple, dtype: str) -> str:
    return f"{name}@{'x'.join(map(str, shape))}/{dtype}"


# ------------------------------------------------------------------ inputs


def draw_inputs(path: Path, seed: int = 0) -> None:
    """Every config's weights (f32) and two batches, from numpy's
    ``default_rng(seed)``: weights normal at the reference's fan-in scale,
    norms ``1 + 0.1 * normal`` (so their gradients matter), helper inputs
    standard normal."""
    rng = np.random.default_rng(seed)
    out: dict[str, np.ndarray] = {}
    for name, cfg in CONFIGS.items():
        specs = Model(cfg).param_specs()
        for key, spec in _flat(specs).items():
            if spec.init in ("ones", "zeros"):
                a = 1.0 + 0.1 * rng.standard_normal(spec.shape)
            else:
                fan = (spec.shape[-1] if spec.init == "embed" else int(
                    np.prod([n for n, ax in zip(spec.shape[:-1], spec.axes)
                             if ax not in ("layers", "groups")]) or 1))
                a = rng.standard_normal(spec.shape) * fan ** -0.5
            out[f"{name}/{key}"] = a.astype(np.float32)
    for i in ("", "2"):
        toks = rng.integers(0, _DENSE.vocab_size, size=(BATCH, SEQ + 1))
        out["tokens" + i] = toks[:, :-1].astype(np.int32)
        out["labels" + i] = toks[:, 1:].astype(np.int32)
    out["x"] = rng.standard_normal((BATCH, SEQ, _DENSE.d_model)
                                   ).astype(np.float32)
    np.savez(path, **out)


def _flat(tree: dict, prefix: str = "") -> dict:
    flat = {}
    for k in sorted(tree):
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            flat.update(_flat(tree[k], key))
        else:
            flat[key] = tree[k]
    return flat


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *path, last = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def load(path: Path, name: str, dtype: str = "float32"):
    """(params, batch, batch2, x) of config ``name`` as full CPU tensors,
    params in ``dtype`` but for the f32 ones of the spec (the router)."""
    data = np.load(path)
    specs = _flat(Model(CONFIGS[name]).param_specs())
    params = _nest({k: torch.from_numpy(data[f"{name}/{k}"]).to(
        torch.float32 if s.dtype == torch.float32 else getattr(torch, dtype))
        for k, s in specs.items()})
    batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "labels")}
    batch2 = {k: torch.from_numpy(data[k + "2"])
              for k in ("tokens", "labels")}
    return params, batch, batch2, torch.from_numpy(data["x"])


# ------------------------------------------------------------------- cases


def run_case(name: str, params: dict, batch: dict, mesh=None,
             record: bool = False, cfg=None) -> dict:
    """One train step of config ``name`` (or ``cfg``) from ``params`` on
    ``batch`` (full tensors), sharded over ``mesh`` (bound by the caller)
    or on one process: the loss, every gradient and every parameter after
    the step (gathered), the grad norm, and with ``record`` the attested
    step's collectives and findings."""
    cfg = cfg or CONFIGS[name]
    model = Model(cfg)
    shape = ShapeConfig("t", "train", SEQ, BATCH)
    run = RunConfig(cfg, shape, TC, rules="train")
    state = TrainState(params, adamw.init(params))
    p_sh = s_sh = None
    if mesh is not None:
        s_sh = B.state_shardings(model, mesh)
        p_sh = s_sh.params
        state = B.shard(state, s_sh)
        batch = B.shard_batch(model, shape, mesh, batch)
    live = P.tree_map(lambda t: t.detach().requires_grad_(True), state.params)
    loss, _ = model.loss(live, batch, remat=TC.remat, z_loss=TC.z_loss)
    loss.backward()
    grads = P.tree_map(lambda t: t.grad, live)
    step = make_train_step(model, run)
    if record:
        with attest.record() as program:
            state, metrics = step(state, batch)
    else:
        state, metrics = step(state, batch)
    out = {"loss": float(loss.detach()), "step_loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"]),
           "grads": grads, "params": state.params}
    if mesh is not None:
        out["grads"] = B.unshard(grads, p_sh)
        out["params"] = B.unshard(state.params, p_sh)
    out["state"] = state
    if record:
        report = attest.parse_program(program.text, mesh.size())
        audit = RunAudit(AuditContext(workload="train", family=cfg.family,
                                      arch=cfg.name,
                                      mesh=tuple(mesh.shape)))
        out["program"] = {
            "ops": [(op.kind, op.payload_bytes) for op in report.ops],
            "backends": sorted({line.rsplit(" over ", 1)[1]
                                for line in program.lines
                                if " over " in line}),
            "findings": report.findings,
            "audit": audit.evaluate(transport=report)}
    return out


def _backward_elsewhere(name: str, params: dict, batch: dict, mesh,
                        cfg=None) -> dict:
    """Every gradient (gathered) of the sharded loss with its backward, and
    so the remat recomputes, run on a thread of its own, as autograd runs a
    CUDA backward: the binding is thread-local, and the recompute must see
    the forward's."""
    import threading
    model = Model(cfg or CONFIGS[name])
    shape = ShapeConfig("t", "train", SEQ, BATCH)
    p_sh = B.param_shardings(model, mesh)
    live = P.tree_map(lambda t: t.detach().requires_grad_(True),
                      B.shard(params, p_sh))
    loss, _ = model.loss(live, B.shard_batch(model, shape, mesh, batch),
                         remat=TC.remat, z_loss=TC.z_loss)
    errors = []

    def backward():
        try:
            loss.backward()
        except Exception as e:      # raised again on the caller's thread
            errors.append(e)
    thread = threading.Thread(target=backward)
    thread.start()
    thread.join()
    if errors:
        raise errors[0]
    return B.unshard(P.tree_map(lambda t: t.grad, live), p_sh)


def _layer0(directory: Path, name: str) -> tuple[dict, torch.Tensor]:
    """Layer 0 of config ``name`` in the step's compute layout on this
    rank, and the helper input ``x`` as this rank's residual shard."""
    params, _, _, x = load(directory / "inputs.npz", name)
    specs = Model(CONFIGS[name]).param_specs()["layers"]
    local = P.tree_map(lambda t: t[0],
                       B.shard(params["layers"], P.partition(specs)))
    spec = _current().resolve(("act_batch", "act_res", None),
                              tuple(x.shape))
    return (P.gathered(local, specs, stacked=True),
            _current().shard(x, spec))


def _helpers(directory: Path) -> dict:
    """The sharded layer functions on this rank's shards, gathered: SwiGLU
    (``sp_col_projects``, ``rs_project``), attention (``full_attention``
    on this rank's heads) and ``moe_ffn`` (experts exchanged), each on the
    helper input ``x`` and layer 0's weights."""
    ctx = _current()
    res = ctx.resolve(("act_batch", "act_res", None), (BATCH, SEQ, 1))
    out = {}
    name = "gpad" if ctx.axis_sizes["model"] == 4 else "dense"
    p, x = _layer0(directory, name)
    out["attention"] = ctx.unshard(full_attention(CONFIGS[name], p["attn"],
                                                  x), res)
    if name == "dense":
        out["swiglu"] = ctx.unshard(swiglu(p["mlp"], x), res)
        p, x = _layer0(directory, "moe")
        y, aux = moe_ffn(CONFIGS["moe"], p["moe"], x)
        out["moe"] = ctx.unshard(y, res)
        out["moe_aux"] = ctx.unshard(aux, res[:2])
    return out


def _tracked_save(directory: Path, state: TrainState, shardings) -> dict:
    """Save ``state`` as checkpoint 1, counting the gathered leaves and,
    at each gather, how many earlier gathered leaves (and their arrays on
    the writing rank) are still alive: a save holds one at a time."""
    live: list = []
    seen = {"gathers": 0, "live_max": 0}
    unshard, to_numpy = ShardCtx.unshard, ckpt_mod._to_numpy

    def tracked_unshard(self, local, spec):
        seen["gathers"] += 1
        seen["live_max"] = max(seen["live_max"],
                               sum(r() is not None for r in live))
        out = unshard(self, local, spec)
        live.append(weakref.ref(out))
        return out

    def tracked_to_numpy(t):
        arr, name = to_numpy(t)
        live.append(weakref.ref(arr))
        return arr, name
    ShardCtx.unshard, ckpt_mod._to_numpy = tracked_unshard, tracked_to_numpy
    try:
        CheckpointManager(directory).save(1, state, shardings=shardings)
    finally:
        ShardCtx.unshard, ckpt_mod._to_numpy = unshard, to_numpy
    return {**seen, "leaves": len(P.leaves(state.params)) * 4 + 1}


def _failed_save(directory: Path, state: TrainState, shardings) -> dict:
    """A sharded save whose writer (rank 0) fails at its first leaf: what
    each rank raises, and whether a checkpoint was committed."""
    write_array = np.lib.format.write_array

    def fail(*args, **kwargs):
        raise OSError("no space left on device")
    if dist.get_rank() == 0:
        np.lib.format.write_array = fail
    try:
        CheckpointManager(directory).save(1, state, shardings=shardings)
        raised = None
    except (OSError, RuntimeError) as e:
        raised = f"{type(e).__name__}: {e}"
    finally:
        np.lib.format.write_array = write_array
    return {"raised": raised,
            "committed": CheckpointManager(directory).latest_step()}


def _restore_step(directory: Path, mesh) -> float:
    """The loss of the step after the checkpoint that world 4 wrote at
    (2, 2), restored onto ``mesh``."""
    ckpt = directory.parent / "ckpt"
    deadline = time.monotonic() + TIMEOUT_S
    while not (ckpt / "step_00000001").is_dir():
        if time.monotonic() > deadline:
            raise TimeoutError("no checkpoint from the (2, 2) mesh")
        time.sleep(0.2)
    params, _, batch2, _ = load(directory / "inputs.npz", "dense")
    s_sh = B.state_shardings(Model(CONFIGS["dense"]), mesh)
    like = B.shard(TrainState(params, adamw.init(params)), s_sh)
    state = CheckpointManager(ckpt).restore(1, like, shardings=s_sh)
    return _next_loss("dense", state, batch2, mesh)


def _refusal(arch: str, seq: int = SEQ) -> str | None:
    """The ``ValueError`` that ``arch``'s loss raises on the bound mesh at
    ``seq`` tokens."""
    model = Model(reduced(ALL_ARCHS[arch]))
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    batch = model.sample_batch(ShapeConfig("t", "train", seq, BATCH), 0,
                               "cpu")
    try:
        model.loss(params, batch)
    except ValueError as e:
        return str(e)
    return None


def _next_loss(name: str, state: TrainState, batch: dict, mesh) -> float:
    model = Model(CONFIGS[name])
    shape = ShapeConfig("t", "train", SEQ, BATCH)
    step = make_train_step(model, RunConfig(model.cfg, shape, TC,
                                            rules="train"))
    _, metrics = step(state, B.shard_batch(model, shape, mesh, batch))
    return float(metrics["loss"])


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
                params, batch, batch2, _ = load(d / "inputs.npz", name, dtype)
                with bind(mesh, RULESETS["train"]):
                    res = run_case(name, params, batch, mesh, record=True)
                    if (name, shape) == ("dense", (1, 2)):
                        again = run_case(name, params, batch, mesh)
                        res["again"] = {k: again[k] for k in
                                        ("loss", "params", "grads")}
                        res["thread_grads"] = _backward_elsewhere(
                            name, params, batch, mesh)
                    if (name, shape) == ("dense", (2, 2)):
                        s_sh = B.state_shardings(Model(CONFIGS[name]), mesh)
                        res["save"] = _tracked_save(d.parent / "ckpt",
                                                    res["state"], s_sh)
                        res["failed_save"] = _failed_save(
                            d.parent / "ckpt_fail", res["state"], s_sh)
                        res["next_loss"] = _next_loss(name, res["state"],
                                                      batch2, mesh)
                    if (name, shape) in (("dense", (2, 2)), ("gpad", (1, 4))):
                        res["helpers"] = _helpers(d)
                    if dtype == "bfloat16" or (name, shape) == ("dense",
                                                                (2, 2)):
                        model = Model(CONFIGS[name])
                        res["shardings"] = {
                            "params": B.param_shardings(model, mesh),
                            "placements": P.tree_map(
                                lambda s: [str(x) for x in sharding_for(
                                    s.axes, s.shape)],
                                model.param_specs()),
                            "batch": B.batch_shardings(model, ShapeConfig(
                                "t", "train", SEQ, BATCH), mesh)}
                del res["state"]
                if rank:
                    res = {k: res[k] for k in ("loss", "step_loss",
                                               "grad_norm", "save",
                                               "failed_save") if k in res}
                out[case_key(name, shape, dtype)] = res
            if world == 2:
                mesh = mesh_of((1, 2), AXES[2], "cpu")
                with bind(mesh, RULESETS["train"]):
                    out["restored_loss"] = _restore_step(d, mesh)
                    out["refusals"] = {
                        fam: _refusal(arch, REFUSED_SEQ.get(fam, SEQ))
                        for fam, arch in REFUSED.items()}
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except Exception:                  # reported to the test, then raised
        out["error"] = traceback.format_exc()
        raise
    finally:
        torch.save(out, d / f"rank{rank}.pt")


# --------------------------------------------------------------- processes


def start(worlds: tuple[int, ...], directory: Path) -> dict:
    """Start every world's ranks at once (a directory a world under
    ``directory``, which holds ``inputs.npz``)."""
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


def join(handle: dict) -> dict[int, list[dict]]:
    """Each world's results in rank order; fails if a rank failed or
    outlived its deadline."""
    every = [p for ps in handle["procs"].values() for p in ps]
    try:
        for p in every:
            p.join(max(handle["deadline"] - time.monotonic(), 0.0))
    finally:
        for p in every:
            if p.is_alive():
                p.kill()
                p.join()
    results, errors = {}, []
    for world, ps in handle["procs"].items():
        results[world] = []
        for r, p in enumerate(ps):
            path = handle["dir"] / f"world{world}" / f"rank{r}.pt"
            res = torch.load(path, weights_only=False) if path.exists() else {}
            if p.exitcode != 0 or "error" in res:
                errors.append((world, r, p.exitcode, res.get("error")))
            results[world].append(res)
    assert not errors, errors
    return results
