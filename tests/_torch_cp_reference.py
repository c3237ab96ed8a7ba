"""The reference's sharded results for ``tests/test_torch_context_parallel.py``.

Run as ``python tests/_torch_cp_reference.py DIR`` in a process of its
own, with eight host devices (as ``tests/_torch_tp_reference.py``): it
reads ``DIR/inputs.npz`` (``_torch_cp_ranks.draw_inputs``) and writes
``DIR/reference.npz``: for each case of ``STEPS`` the loss, the grad norm,
every gradient and every parameter after one step of the reference's
jitted train step under GSPMD shardings (its Mamba2 layers through
``mamba_block_cp``'s ``shard_map`` body wherever a model axis admits it),
the bf16 losses at (2, 2, 2), and ``mamba_block_cp`` with ``return_state``
on layer 0 at (1, 2) and (1, 4): y, the conv tail, the final state and
the gradients of ``_torch_cp_ranks._block``'s loss.  In f32 the bf16 pin
on the residual cotangents is lifted (ROADMAP caveat f).
"""
import os
import sys
from pathlib import Path

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.models.layers as r_layers  # noqa: E402
import repro.models.stack as r_stack  # noqa: E402
from repro.configs import ALL_ARCHS, reduced  # noqa: E402
from repro.configs.base import RunConfig, ShapeConfig, TrainConfig  # noqa: E402
from repro.launch.bind import (batch_shardings, param_shardings,  # noqa: E402
                               state_shardings)
from repro.launch.mesh import mesh_of  # noqa: E402
from repro.models import build  # noqa: E402
from repro.models.params import ParamSpec  # noqa: E402
from repro.models.ssm import mamba_block_cp  # noqa: E402
from repro.optim import adamw  # noqa: E402
from repro.parallel import bind, rules_for  # noqa: E402
from repro.train.step import TrainState, make_train_step  # noqa: E402

r_stack._bf16_tangent = lambda x: x
r_layers.bf16_tangent = lambda x: x

SEQ, BATCH = 32, 4
TC = TrainConfig(learning_rate=1e-2, warmup_steps=0, total_steps=10,
                 eps=1e-2, remat="full")
CONFIGS = {
    "ssm": dataclasses.replace(reduced(ALL_ARCHS["mamba2-2.7b"]), n_layers=2),
    "hybrid": reduced(ALL_ARCHS["zamba2-2.7b"]),
}
STEPS = [(name, dims) for name in ("ssm", "hybrid")
         for dims in ((1, 2), (2, 1), (1, 4), (2, 2))]
BLOCKS = ((1, 2), (1, 4))
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def _tree(data, name: str, dtype) -> dict:
    model = build(CONFIGS[name])
    flat, treedef = jax.tree_util.tree_flatten_with_path(
        model.param_specs(), is_leaf=lambda x: isinstance(x, ParamSpec))
    leaves = []
    for path, spec in flat:
        key = "/".join(p.key for p in path)
        want = jnp.float32 if spec.dtype == jnp.float32 else dtype
        leaves.append(jnp.asarray(data[f"{name}/{key}"], dtype=want))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _flat(tree, prefix: str) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                       for p in path)
        out[f"{prefix}/{key}"] = np.asarray(leaf, np.float32)
    return out


def _key(name: str, dims) -> str:
    return f"{name}@{'x'.join(map(str, dims))}"


def main(directory: Path) -> None:
    data = np.load(directory / "inputs.npz")
    batch = {"tokens": jnp.asarray(data["tokens"]),
             "labels": jnp.asarray(data["labels"])}
    shape = ShapeConfig("t", "train", SEQ, BATCH)
    out: dict[str, np.ndarray] = {}
    for name, dims in STEPS:
        cfg = CONFIGS[name]
        model = build(cfg)
        run = RunConfig(model=cfg, shape=shape, train=TC, rules="train")
        step = make_train_step(model, run)

        def fn(state, b):
            (loss, _), grads = jax.value_and_grad(
                lambda p: model.loss(p, b, remat=TC.remat, z_loss=TC.z_loss),
                has_aux=True)(state.params)
            state, metrics = step(state, b)
            return state, metrics, grads, loss

        params = _tree(data, name, jnp.float32)
        mesh = mesh_of(dims, AXES[2])
        with bind(mesh, rules_for(run)):
            st_sh = state_shardings(model, mesh)
            b_sh = batch_shardings(model, shape, mesh)
            state = jax.device_put(TrainState(params, adamw.init(params)),
                                   st_sh)
            new, metrics, grads, loss = jax.jit(
                fn, in_shardings=(st_sh, b_sh),
                out_shardings=(st_sh, None, st_sh.params, None))(
                    state, jax.device_put(batch, b_sh))
        key = _key(name, dims)
        out[f"{key}/loss"] = np.float32(loss)
        out[f"{key}/grad_norm"] = np.float32(metrics["grad_norm"])
        out.update(_flat(grads, f"{key}/grads"))
        out.update(_flat(new.params, f"{key}/params"))

    mesh = mesh_of((2, 2, 2), AXES[3])
    for name, cfg in CONFIGS.items():
        model = build(cfg)
        run = RunConfig(model=cfg, shape=shape, rules="train")
        params = _tree(data, name, jnp.bfloat16)
        with bind(mesh, rules_for(run)):
            loss, _ = jax.jit(lambda p, b: model.loss(p, b))(
                jax.device_put(params, param_shardings(model, mesh)),
                jax.device_put(batch, batch_shardings(model, shape, mesh)))
        out[f"{name}@2x2x2/bf16_loss"] = np.float32(loss)

    cfg = CONFIGS["ssm"]
    layer0 = jax.tree.map(lambda a: a[0],
                          _tree(data, "ssm", jnp.float32)["layers"]["mamba"])
    x, gy = jnp.asarray(data["x"]), jnp.asarray(data["gy"])
    g_tail, g_state = jnp.asarray(data["g_tail"]), jnp.asarray(data["g_state"])

    def block_loss(p, x):
        y, (tail, state) = mamba_block_cp(cfg, p, x, return_state=True)
        loss = (jnp.sum(y * gy) + jnp.sum(tail * g_tail)
                + jnp.sum(state * g_state))
        return loss, (y, tail, state)

    for dims in BLOCKS:
        run = RunConfig(model=cfg, shape=shape, rules="train")
        key = _key("ssm", dims)
        with bind(mesh_of(dims, AXES[2]), rules_for(run)):
            (_, (y, tail, state)), (g_p, g_x) = jax.jit(jax.value_and_grad(
                block_loss, argnums=(0, 1), has_aux=True))(layer0, x)
        out[f"{key}/block/y"] = np.asarray(y)
        out[f"{key}/block/tail"] = np.asarray(tail)
        out[f"{key}/block/state"] = np.asarray(state)
        out[f"{key}/block/dx"] = np.asarray(g_x)
        out.update(_flat(g_p, f"{key}/block/grads"))
    np.savez(directory / "reference.npz", **out)


if __name__ == "__main__":
    main(Path(sys.argv[1]))
