"""Late binding of a portable (model, shape, rules) description onto a
mesh: the shardings of the train state and of batches.

Port of ``repro.launch.bind``.  A sharding here is the reference's
``PartitionSpec`` as a tuple (``parallel.ctx.resolve``), one a leaf,
resolved under the rules ``parallel.bind`` holds; ``shard`` cuts a full
tree to this rank's slices by them (where the reference calls
``jax.device_put``), and ``unshard`` gathers a sharded tree back.  The
reference's ``cache_shardings`` and ``abstract_cell`` wait for the
serving and dry-run slices of the port.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.models import params as P
from repro_torch.models.model import Model
from repro_torch.optim.adamw import OptState
from repro_torch.parallel.ctx import _current, resolve
from repro_torch.train.step import TrainState

_BATCH_AXES: dict[str, tuple[str | None, ...]] = {
    "tokens": ("act_batch", "act_seq"),
    "labels": ("act_batch", "act_seq"),
    "token": ("act_batch", None),
    "pos": ("act_batch",),
    "image_embed": ("act_batch", None, None),
    "audio_embed": ("act_batch", "act_seq", None),
}


def _bound(mesh):
    ctx = _current()
    if ctx is None or ctx.mesh is not mesh:
        raise ValueError("bind `mesh` first (parallel.bind)")
    return ctx


def batch_shardings(model: Model, shape: ShapeConfig, mesh) -> dict:
    _bound(mesh)
    return {name: resolve(_BATCH_AXES[name], dims)
            for name, (dims, _) in model.input_specs(shape).items()}


def param_shardings(model: Model, mesh) -> Any:
    _bound(mesh)
    return P.partition(model.param_specs())


def state_shardings(model: Model, mesh) -> TrainState:
    ps = param_shardings(model, mesh)
    return TrainState(params=ps, opt=OptState(step=(), master=ps, m=ps, v=ps))


def shard(tree: Any, shardings: Any) -> Any:
    """This rank's slices of the full ``tree`` (a state, params or a
    batch) under ``shardings``."""
    ctx = _current()
    return P.tree_map2(lambda t, spec: ctx.shard(t, spec), tree, shardings)


def unshard(tree: Any, shardings: Any) -> Any:
    """The full tree of which ``tree`` holds this rank's slices; every rank
    calls it."""
    ctx = _current()
    return P.tree_map2(lambda t, spec: ctx.unshard(t, spec), tree,
                       shardings)


def shard_batch(model: Model, shape: ShapeConfig, mesh,
                batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """This rank's rows of a full batch."""
    return shard(batch, batch_shardings(model, shape, mesh))
