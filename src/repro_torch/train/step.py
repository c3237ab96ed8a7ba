"""Train-step factory: loss → grads → AdamW, with optional gradient
accumulation (microbatching) and int8 error-feedback gradient compression.

Port of ``repro.train.step``.  ``make_train_step`` returns a
``(state, batch) -> (state, metrics)`` function, as the reference's; it
updates the state in place (see ``optim.adamw.apply``) and returns it.
Called inside ``parallel.bind`` over a mesh, it takes each rank's shards
of the state and the batch (``launch.bind``): the model's collectives
reduce every gradient over the axes that split its computation (a
reduce-scatter over the axes its parameter is sharded on, a sum over the
ones it is replicated on), the global norm counts each element once, and
the optimizer updates the rank's slices, so ZeRO-3 follows as in the
reference.  The loss and the metrics are the global ones on every rank.
Metrics stay on the device: reading one (``float(metrics["loss"])``) is
the caller's host sync.  ``train_state_from_jax`` is the state bridge: a
reference ``TrainState`` as numpy becomes the port's, bit for bit.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models.model import Model
from repro_torch.models.params import from_jax, shard_groups, tree_map
from repro_torch.parallel.ctx import _current
from repro_torch.optim import adamw


class TrainState(NamedTuple):
    params: Any
    opt: adamw.OptState


def init_train_state(model: Model, generator: torch.Generator,
                     device: str | torch.device) -> TrainState:
    params = model.init_params(generator, device)
    return TrainState(params=params, opt=adamw.init(params))


def train_state_from_jax(state: Any, device: str | torch.device = "cpu"
                         ) -> TrainState:
    """The reference's ``TrainState`` (params and ``OptState`` step,
    master, m, v; numpy or JAX arrays) as the port's tensors on
    ``device``."""
    opt = state.opt
    return TrainState(
        params=from_jax(state.params, device),
        opt=adamw.OptState(step=from_jax(opt.step, device),
                           master=from_jax(opt.master, device),
                           m=from_jax(opt.m, device),
                           v=from_jax(opt.v, device)))


def make_train_step(model: Model, run: RunConfig) -> Callable:
    tc = run.train

    def value_and_grad(params: Any, batch: dict):
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, metrics = model.loss(live, batch, remat=tc.remat,
                                       z_loss=tc.z_loss)
            loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree_map(lambda t: t.grad, live)

    def compute_grads(params: Any, batch: dict):
        n = tc.microbatches
        if not n or n <= 1:
            return value_and_grad(params, batch)
        b = batch["tokens"].shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split into {n} microbatches")
        size = b // n
        # fp32 running sums of loss / n and g / n (the reference's scan
        # starts them at zero; 0 + x is x); metrics of the last microbatch
        loss, grads = 0.0, None
        for i in range(n):
            micro = {k: x[i * size:(i + 1) * size] for k, x in batch.items()}
            l_i, metrics, g_i = value_and_grad(params, micro)
            part = tree_map(lambda g: g.float() / n, g_i)
            grads = part if grads is None else _add(grads, part)
            loss = loss + l_i / n
        return loss, metrics, grads

    def train_step(state: TrainState, batch: dict):
        ctx = _current()
        sharded = ctx is not None and ctx.mesh.size() > 1
        if sharded and tc.grad_compress != "none":
            raise ValueError("int8 gradient compression scales each tensor "
                             "by its max, which a sharded step does not "
                             "have on one rank")
        loss, metrics, grads = compute_grads(state.params, batch)
        if tc.grad_compress == "int8_ef":
            from repro_torch.optim.compress import compress_decompress
            grads = compress_decompress(grads)
        groups = shard_groups(model.param_specs()) if sharded else None
        params, opt, opt_metrics = adamw.apply(tc, state.opt, grads,
                                               state.params, groups)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return TrainState(params, opt), metrics

    return train_step


def _add(a: Any, b: Any) -> Any:
    if isinstance(a, dict):
        return {k: _add(a[k], b[k]) for k in a}
    return a + b
