"""Collectives over a bound mesh's process groups, as autograd functions.

The reference shards with GSPMD annotations and ``shard_map`` bodies whose
collectives JAX differentiates.  The port holds each rank's shards as
plain tensors, so every collective the step needs is written here once,
each with its transpose as its backward:

* ``all_gather`` (forward) / reduce-scatter (backward), along one dim;
* ``reduce_scatter`` (forward, a sum) / all-gather (backward);
* ``all_to_all`` (forward) / the same exchange (backward): chunk ``j`` of
  dim 0 goes to the group's rank ``j``, the output's chunk ``i`` came from
  rank ``i``;
* ``shift``: rank ``i`` of the group sends to rank ``i + 1`` (send/recv,
  the reference's ``ppermute`` over ``[(i, i + 1)]``), rank 0 receives
  zeros; the backward is the reverse shift, and the last rank's cotangent
  is dropped (no rank took its tensor);
* ``all_reduce``: a sum forward, the identity backward.  Its consumers
  run on every rank of the group alike (the loss, its statistics), so
  each rank's cotangent is already the whole one;
* ``sum_grads``: the identity forward, a sum of the gradient backward.  A
  parameter replicated over axes that split the computation (a norm on
  sequence shards, the router on its tokens) gets a part of its gradient
  on each rank.

Each but ``shift`` is the identity where the group is ``None`` (a group
of one rank).
The payload keeps the tensor's dtype: bf16 activations and gradients
travel as bf16.  gloo takes CUDA tensors in all of them but ``shift`` and
stages them through host memory inside the op; ``shift`` copies a CUDA
tensor to the host itself, since gloo's send and recv take host memory
only.  The attested program reports either as a ``host-transfer``
(``core.attest``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather ``x`` along ``dim`` over ``group`` (no autograd): the
    ranks' shards in group-rank order."""
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((group.size() * xt.shape[0],) + xt.shape[1:])
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Reduce-scatter (sum) ``x`` along ``dim`` over ``group`` (no
    autograd): this rank's chunk of the sum."""
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // group.size(),) + xt.shape[1:])
    dist.reduce_scatter_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def sum_all(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) a copy of ``x`` over ``group`` (no autograd)."""
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def pass_on(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Group rank ``i`` sends ``x`` to rank ``i + step`` and receives from
    rank ``i - step`` (no autograd; ``step`` is 1 or -1, no wrap-around):
    the received tensor, zeros where no rank sends to this one.  The sends
    and receives go out together (``batch_isend_irecv``), so no order of
    the ranks deadlocks.  gloo's send and recv read and write host memory
    only, so a device tensor travels over gloo through a host copy made
    here."""
    staged = x.device.type != "cpu" and dist.get_backend(group) == "gloo"
    me, n = group.rank(), group.size()
    sends, takes = 0 <= me + step < n, 0 <= me - step < n
    out = torch.zeros(x.shape, dtype=x.dtype,
                      device="cpu" if staged and takes else x.device)
    ops = []
    if sends:
        ops.append(dist.P2POp(dist.isend,
                              (x.cpu() if staged else x).contiguous(),
                              dist.get_global_rank(group, me + step), group))
    if takes:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, me - step), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(x.device)


def exchange(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` along dim 0 over ``group`` (no autograd)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return scatter_dim(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return scatter_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return exchange(g, ctx.group), None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return pass_on(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return pass_on(g, ctx.group, -1), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return sum_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_all(g, ctx.group), None


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _AllGather.apply(x, dim, group)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _ReduceScatter.apply(x, dim, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _AllToAll.apply(x, group)


def shift(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of the group's previous rank (zeros on rank 0).  A group of
    one rank has no previous rank to take from, so ``group`` must be a
    group of two or more."""
    if group is None:
        raise ValueError("shift needs a group of two or more ranks")
    return _Shift.apply(x, group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _AllReduce.apply(x, group)


def sum_grads(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _SumGrads.apply(x, group)
