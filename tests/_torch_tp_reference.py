"""The reference's sharded results for ``tests/test_torch_tensor_parallel.py``.

Run as ``python tests/_torch_tp_reference.py DIR`` in a process of its
own, with eight host devices (as ``tests/test_integration.py`` runs its
sharded cases): it reads ``DIR/inputs.npz`` (``_torch_tp_ranks.draw_inputs``)
and writes ``DIR/reference.npz``: for each case of ``STEPS`` the loss, the
grad norm, every gradient and every parameter after one step of the
reference's jitted train step under GSPMD shardings (``launch.bind``), the
bf16 losses at (2, 2, 2), and the layer functions of ``_torch_tp_ranks``'s
helpers at (2, 2) and (1, 4).  In f32 the bf16 pin on the residual
cotangents is lifted (ROADMAP caveat f: JAX refuses it for f32 parameters).
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
from repro.launch.bind import batch_shardings, state_shardings  # noqa: E402
from repro.launch.mesh import mesh_of  # noqa: E402
from repro.models import build  # noqa: E402
from repro.models.attention import full_attention  # noqa: E402
from repro.models.layers import swiglu  # noqa: E402
from repro.models.moe import moe_ffn  # noqa: E402
from repro.optim import adamw  # noqa: E402
from repro.parallel import bind, rules_for  # noqa: E402
from repro.train.step import TrainState, make_train_step  # noqa: E402

r_stack._bf16_tangent = lambda x: x
r_layers.bf16_tangent = lambda x: x

SEQ, BATCH = 32, 4
TC = TrainConfig(learning_rate=1e-2, warmup_steps=0, total_steps=10,
                 eps=1e-2, remat="full")
_DENSE = dataclasses.replace(reduced(ALL_ARCHS["deepseek-7b"]), n_layers=2)
_MOE = dataclasses.replace(reduced(ALL_ARCHS["granite-moe-1b-a400m"]),
                           n_layers=2)
CONFIGS = {"dense": _DENSE,
           "gpad": dataclasses.replace(_DENSE, n_heads=6, n_kv_heads=2),
           "moe": _MOE}
STEPS = [("dense", (1, 2)), ("dense", (2, 1)), ("dense", (2, 2)),
         ("gpad", (1, 4)), ("moe", (1, 2)), ("moe", (2, 1)), ("moe", (2, 2))]
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def _tree(data, name: str, dtype) -> dict:
    model = build(CONFIGS[name])
    flat, treedef = jax.tree_util.tree_flatten_with_path(model.param_specs(),
                                                         is_leaf=_is_spec)
    leaves = []
    for path, spec in flat:
        key = "/".join(p.key for p in path)
        want = jnp.float32 if spec.dtype == jnp.float32 else dtype
        leaves.append(jnp.asarray(data[f"{name}/{key}"], dtype=want))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _is_spec(x) -> bool:
    from repro.models.params import ParamSpec
    return isinstance(x, ParamSpec)


def _flat(tree, prefix: str) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                       for p in path)
        out[f"{prefix}/{key}"] = np.asarray(leaf, np.float32)
    return out


def main(directory: Path) -> None:
    data = np.load(directory / "inputs.npz")
    batch = {"tokens": jnp.asarray(data["tokens"]),
             "labels": jnp.asarray(data["labels"])}
    shape = ShapeConfig("t", "train", SEQ, BATCH)
    out: dict[str, np.ndarray] = {}
    for name, dims in STEPS:
        cfg = CONFIGS[name]
        model = build(cfg)
        mesh = mesh_of(dims, AXES[len(dims)])
        run = RunConfig(model=cfg, shape=shape, train=TC, rules="train")
        step = make_train_step(model, run)

        def fn(state, b):
            (loss, _), grads = jax.value_and_grad(
                lambda p: model.loss(p, b, remat=TC.remat, z_loss=TC.z_loss),
                has_aux=True)(state.params)
            state, metrics = step(state, b)
            return state, metrics, grads, loss

        params = _tree(data, name, jnp.float32)
        with bind(mesh, rules_for(run)):
            st_sh = state_shardings(model, mesh)
            b_sh = batch_shardings(model, shape, mesh)
            state = jax.device_put(TrainState(params, adamw.init(params)),
                                   st_sh)
            new, metrics, grads, loss = jax.jit(
                fn, in_shardings=(st_sh, b_sh),
                out_shardings=(st_sh, None, st_sh.params, None))(
                    state, jax.device_put(batch, b_sh))
        key = f"{name}@{'x'.join(map(str, dims))}"
        out[f"{key}/loss"] = np.float32(loss)
        out[f"{key}/grad_norm"] = np.float32(metrics["grad_norm"])
        out.update(_flat(grads, f"{key}/grads"))
        out.update(_flat(new.params, f"{key}/params"))

    mesh = mesh_of((2, 2, 2), AXES[3])
    for name in ("dense", "moe"):
        model = build(CONFIGS[name])
        run = RunConfig(model=CONFIGS[name], shape=shape, rules="train")
        params = _tree(data, name, jnp.bfloat16)
        with bind(mesh, rules_for(run)):
            from repro.launch.bind import param_shardings
            loss, _ = jax.jit(lambda p, b: model.loss(p, b))(
                jax.device_put(params, param_shardings(model, mesh)),
                jax.device_put(batch, batch_shardings(model, shape, mesh)))
        out[f"{name}@2x2x2/bf16_loss"] = np.float32(loss)

    x = jnp.asarray(data["x"])
    for name, dims in (("dense", (2, 2)), ("gpad", (1, 4))):
        cfg = CONFIGS[name]
        layer0 = jax.tree.map(lambda a: a[0],
                              _tree(data, name, jnp.float32)["layers"])
        moe0 = jax.tree.map(lambda a: a[0],
                            _tree(data, "moe", jnp.float32)["layers"])
        run = RunConfig(model=cfg, shape=shape, rules="train")
        key = f"{name}@{'x'.join(map(str, dims))}"
        with bind(mesh_of(dims, AXES[2]), rules_for(run)):
            out[f"{key}/attention"] = np.asarray(jax.jit(
                lambda p, x: full_attention(cfg, p, x))(layer0["attn"], x))
            if name == "dense":
                out[f"{key}/swiglu"] = np.asarray(jax.jit(swiglu)(
                    layer0["mlp"], x))
                y, aux = jax.jit(lambda p, x: moe_ffn(CONFIGS["moe"], p, x))(
                    moe0["moe"], x)
                out[f"{key}/moe"] = np.asarray(y)
                out[f"{key}/moe_aux"] = np.asarray(aux)
    np.savez(directory / "reference.npz", **out)


if __name__ == "__main__":
    main(Path(sys.argv[1]))
