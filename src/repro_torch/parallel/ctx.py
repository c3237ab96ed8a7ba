"""Sharding context: the late "host binding" for model code.

Port of ``repro.parallel.ctx`` over ``torch.distributed``'s ``DeviceMesh``.
Model code never names mesh axes directly; it names *logical* axes
(``("act_batch", "act_seq", None)``), and a rule set
(``parallel.rules``) binds them to physical mesh axes for the duration of
``bind``: the same model code maps onto any mesh, which is the paper's
portable-image property.

``resolve`` gives the reference's ``PartitionSpec`` as a tuple, one entry a
dimension: ``None``, a mesh axis name, or a tuple of names.
``sharding_for`` turns it into the ``DTensor`` placements of the bound
mesh (``Shard(dim)`` on each mesh axis a dimension takes, ``Replicate()``
on the others), what ``torch.distributed.tensor.distribute_tensor`` takes
where the reference takes a ``NamedSharding``.  The reference's
``constrain`` and ``shard_map_compat`` are GSPMD annotations; the port has
no such partitioner, and they wait for its tensor- and expert-parallel
slice.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

_state = threading.local()

Spec = tuple  # one entry a dimension: None, an axis name, or axis names


def _current():
    return getattr(_state, "ctx", None)


class ShardCtx:
    def __init__(self, mesh: DeviceMesh,
                 rules: dict[str, tuple[str, ...] | str | None]):
        self.mesh = mesh
        self.rules = rules
        self.axis_sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def resolve(self, logical: Sequence[str | None],
                shape: Sequence[int] | None = None) -> Spec:
        """Map logical axis names to a PartitionSpec, dropping any mapping
        that would not divide the corresponding dimension evenly and
        de-duplicating mesh axes (first use wins)."""
        used: set[str] = set()
        parts = []
        for i, name in enumerate(logical):
            spec = self.rules.get(name) if name else None
            if spec is None:
                parts.append(None)
                continue
            axes = (spec,) if isinstance(spec, str) else tuple(spec)
            axes = tuple(a for a in axes
                         if a in self.axis_sizes and a not in used)
            if not axes:
                parts.append(None)
                continue
            size = 1
            for a in axes:
                size *= self.axis_sizes[a]
            if shape is not None and shape[i] % size != 0:
                # Uneven: replicate rather than pad implicitly.
                parts.append(None)
                continue
            used.update(axes)
            parts.append(axes[0] if len(axes) == 1 else axes)
        return tuple(parts)

    def placements(self, spec: Spec) -> list:
        """The ``DTensor`` placements of ``spec`` on this mesh, one a mesh
        axis."""
        dim_of = {}
        for dim, part in enumerate(spec):
            for axis in ((part,) if isinstance(part, str) else part or ()):
                dim_of[axis] = dim
        return [Shard(dim_of[a]) if a in dim_of else Replicate()
                for a in self.mesh.mesh_dim_names]


@contextlib.contextmanager
def bind(mesh: DeviceMesh, rules: dict):
    prev = _current()
    _state.ctx = ShardCtx(mesh, rules)
    try:
        yield _state.ctx
    finally:
        _state.ctx = prev


def mesh_of(shape: Sequence[int], axes: Sequence[str],
            device: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the process group
    that stands (``core.bootstrap.init_distributed`` makes it), rank
    ``r`` at row-major position ``r``.  Raises when there is no group, or
    when its world size is not the mesh's device count: no padding, no
    quiet reshape."""
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(
            f"a mesh of {tuple(shape)} needs a process group of {n} ranks; "
            f"none stands (call core.bootstrap.init_distributed first)")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(
            f"a mesh of {tuple(shape)} {tuple(axes)} needs {n} ranks; the "
            f"process group has {world}")
    return init_device_mesh(device, tuple(shape),
                            mesh_dim_names=tuple(axes))


def resolve(logical: Sequence[str | None],
            shape: Sequence[int] | None = None) -> Spec:
    ctx = _current()
    if ctx is None:
        return (None,) * len(logical)
    return ctx.resolve(logical, shape)


def sharding_for(logical: Sequence[str | None],
                 shape: Sequence[int] | None = None):
    ctx = _current()
    if ctx is None:
        return None
    return ctx.placements(ctx.resolve(logical, shape))
