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
on the others).

The port has no partitioner: each rank holds its shards as plain tensors,
and the model's collectives are explicit (``parallel.comm``).  So the
reference's ``constrain`` (a GSPMD annotation) becomes a check that a local
tensor has the shape its logical axes give it, never a reshard, and a
``shard_map`` body of the reference is called on the shards as they are
(no wrapper).  A dimension
sharded over several axes (``embed`` over ``("pod", "data")``) is split
row-major over them, as in the reference.  ``ShardCtx.group`` gives the
process group of a set of axes, ``coordinate`` this rank's index along
them, and ``shard`` and ``unshard`` move a tensor between its global and
local forms.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import threading
from typing import Callable, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from repro_torch.parallel.comm import gather_dim

_state = threading.local()

Spec = tuple  # one entry a dimension: None, an axis name, or axis names


def _current():
    return getattr(_state, "ctx", None)


def _axes(part) -> tuple[str, ...]:
    """A spec entry's mesh axes: ``()``, ``("model",)`` or
    ``("pod", "data")``."""
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def mesh_groups(mesh: DeviceMesh) -> dict:
    """The process groups of ``mesh``'s axis sets, made once a mesh.

    Keyed by a tuple of axes in mesh order, each of size above one: the
    group of the ranks that differ from this one only along those axes
    (the mesh's own group for one axis, the world for all of them).
    ``dist.new_group`` is collective, so every rank makes the groups of
    every set in one order here, when ``bind`` first sees the mesh."""
    groups = getattr(mesh, "_repro_groups", None)
    if groups is not None:
        return groups
    names = [a for a, n in zip(mesh.mesh_dim_names, mesh.shape) if n > 1]
    groups = {}
    for k in range(1, len(names) + 1):
        for axes in itertools.combinations(names, k):
            if k == 1:
                groups[axes] = mesh.get_group(axes[0])
            elif k == len(names):
                groups[axes] = dist.group.WORLD
            else:
                dims = [mesh.mesh_dim_names.index(a) for a in axes]
                rest = [i for i in range(mesh.ndim) if i not in dims]
                size = math.prod(mesh.shape[i] for i in dims)
                rows = mesh.mesh.permute(*rest, *dims).reshape(-1, size)
                me = dist.get_rank()
                for row in rows.tolist():
                    g = dist.new_group(row)
                    if me in row:
                        groups[axes] = g
    mesh._repro_groups = groups
    return groups


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

    def size(self, axes: Sequence[str]) -> int:
        return math.prod(self.axis_sizes.get(a, 1) for a in axes)

    def group(self, axes: Sequence[str]):
        """The process group over ``axes`` (those of size one dropped), or
        ``None`` where that leaves this rank alone."""
        key = tuple(a for a in self.mesh.mesh_dim_names
                    if a in axes and self.axis_sizes[a] > 1)
        return mesh_groups(self.mesh)[key] if key else None

    def coordinate(self, axes: Sequence[str]) -> int:
        """This rank's index along ``axes``, row-major in mesh order: its
        rank in ``group(axes)``, and the shard of a dimension split over
        ``axes`` that it holds."""
        coord = dict(zip(self.mesh.mesh_dim_names,
                         self.mesh.get_coordinate()))
        index = 0
        for a in self.mesh.mesh_dim_names:
            if a in axes:
                index = index * self.axis_sizes[a] + coord[a]
        return index

    def local_shape(self, shape: Sequence[int], spec: Spec
                    ) -> tuple[int, ...]:
        return tuple(n // self.size(_axes(part))
                     for n, part in zip(shape, spec))

    def shard(self, full: torch.Tensor, spec: Spec) -> torch.Tensor:
        """This rank's shard of the global tensor ``full`` under ``spec``
        (a copy)."""
        for dim, part in enumerate(spec):
            axes = _axes(part)
            if axes:
                n = full.shape[dim] // self.size(axes)
                full = full.narrow(dim, self.coordinate(axes) * n, n)
        return full.clone()

    def unshard(self, local: torch.Tensor, spec: Spec) -> torch.Tensor:
        """The global tensor of which ``local`` is this rank's shard under
        ``spec`` (a copy): all-gathered over each sharded dimension's axes
        (every rank of those groups calls it)."""
        for dim, part in enumerate(spec):
            group = self.group(_axes(part))
            if group is not None:
                local = gather_dim(local, dim, group)
        return local.clone(memory_format=torch.contiguous_format)


@contextlib.contextmanager
def bind(mesh: DeviceMesh, rules: dict):
    mesh_groups(mesh)
    prev = _current()
    _state.ctx = ShardCtx(mesh, rules)
    try:
        yield _state.ctx
    finally:
        _state.ctx = prev


def carry(fn: Callable) -> Callable:
    """``fn`` run under the binding that holds now, on whichever thread
    calls it.  The binding is thread-local, and autograd runs a CUDA
    backward, and with it a checkpointed layer's recompute, on a thread of
    its own."""
    ctx = _current()

    def run(*args, **kwargs):
        prev = _current()
        _state.ctx = ctx
        try:
            return fn(*args, **kwargs)
        finally:
            _state.ctx = prev
    return run


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


def constrain(x: torch.Tensor, logical: Sequence[str | None],
              shape: Sequence[int]) -> torch.Tensor:
    """The reference's sharding annotation as a check: ``x`` must be this
    rank's shard of a global tensor of ``shape`` under the bound rules
    (``shape`` itself when none is bound).  Raises ``ValueError``
    otherwise; never reshards."""
    ctx = _current()
    want = (tuple(shape) if ctx is None
            else ctx.local_shape(shape, ctx.resolve(logical, shape)))
    if tuple(x.shape) != want:
        raise ValueError(f"a shard of {tuple(shape)} as {tuple(logical)} "
                         f"has shape {want} here, not {tuple(x.shape)}")
    return x
