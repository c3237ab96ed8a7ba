"""AdamW with fp32 master weights, global-norm clipping and a warmup+cosine
schedule.

Port of ``repro.optim.adamw``, on one device or on each rank's shards.
``OptState`` has the reference's fields.  The state costs 16 bytes per
parameter beside the activations: the bf16 parameters and their bf16
gradients, and fp32 master, m and v.  ``apply`` keeps the reference's arithmetic, op for op
(the clip scale, the moment updates, the bias corrections ``c1`` and
``c2``, decoupled weight decay on the master weights, parameters cast from
the master copy), but works tensor by tensor and **in place**: master, m,
v and the parameters are updated where they lie, and no tree-wide fp32 copy
of the clipped gradients is made (at deepseek-7b width that copy alone
would be 4 bytes per parameter).  A large leaf is updated in slices along
its first (stacked-layer) dimension, so the update's fp32 temporaries stay
near ``SLICE_ELEMENTS`` each: the update is elementwise, so the slices give
the same bits as one pass.  (mamba2-2.7b's stacked ``wxbc`` is 3.5 GB in
fp32, and five temporaries of it do not fit beside the 45 GB state.)
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.params import leaves, tree_map
from repro_torch.parallel import comm

SLICE_ELEMENTS = 1 << 26    # about 256 MB of fp32 a temporary


class OptState(NamedTuple):
    step: torch.Tensor       # int32 scalar, on the parameters' device
    master: Any              # fp32 copies of the params
    m: Any
    v: Any


def init(params: Any) -> OptState:
    device = leaves(params)[0].device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        # copy=True: an fp32 parameter must not alias its master copy
        master=tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                        params),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params),
    )


def schedule(cfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (int tensor), in fp32."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.learning_rate * warm * (0.1 + 0.9 * cos)


def clip_by_global_norm(grads: Any, max_norm: float, groups: Any = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(scale, global_norm)``: the factor every gradient is multiplied by
    in fp32, ``min(1, max_norm / (norm + 1e-9))``.  The reference returns
    the scaled fp32 tree; here ``apply`` scales leaf by leaf.

    ``groups`` (sharded gradients): beside each leaf, the process group of
    the axes it is sharded on (``models.params.shard_groups``).  The leaves'
    sums of squares are added up by group and each sum is reduced over its
    group only, so every element of the global tree counts once: a leaf is
    the same on the ranks of the axes it is replicated on."""
    if groups is None:
        sq = sum(torch.sum(torch.square(g.float())) for g in leaves(grads))
    else:
        by_group: list[list] = []             # [group, sum], first seen
        for g, group in zip(leaves(grads), leaves(groups)):
            part = torch.sum(torch.square(g.float()))
            for entry in by_group:
                if entry[0] is group:
                    entry[1] = entry[1] + part
                    break
            else:
                by_group.append([group, part])
        sq = sum(part if group is None else comm.sum_all(part, group)
                 for group, part in by_group)
    gnorm = torch.sqrt(sq)
    return torch.clamp(max_norm / (gnorm + 1e-9), max=1.0), gnorm


@torch.no_grad()
@torch.profiler.record_function("adamw_update")
def apply(cfg: TrainConfig, state: OptState, grads: Any, params: Any,
          groups: Any = None
          ) -> tuple[Any, OptState, dict[str, torch.Tensor]]:
    """One AdamW update, in place.  Returns (params, new state, metrics);
    the params and the state's master, m and v are the tensors passed in,
    updated.  Sharded, each rank updates its slices (the state shares the
    parameters' shards: ZeRO-3) and ``groups`` is ``clip_by_global_norm``'s.
    A profiler span, ``adamw_update``, holds its device time."""
    scale, gnorm = clip_by_global_norm(grads, cfg.grad_clip, groups)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2, eps, wd = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay
    c1 = 1 - b1 ** step.float()
    c2 = 1 - b2 ** step.float()
    for tensors in zip(leaves(grads), leaves(params), leaves(state.master),
                       leaves(state.m), leaves(state.v)):
        for g, p, master, m, v in zip(*map(_slices, tensors)):
            g = g.float() * scale
            gg = (1 - b2) * g
            v.mul_(b2).add_(gg.mul_(g))        # b2 * v + (1 - b2) * g * g
            m.mul_(b1).add_(g.mul_(1 - b1))    # b1 * m + (1 - b1) * g
            vh = torch.div(v, c2).sqrt_().add_(eps)
            u = torch.div(m, c1).div_(vh)      # mh / (sqrt(vh) + eps)
            u.add_(wd * master)
            master.sub_(u.mul_(lr))            # master - lr * (...)
            p.copy_(master)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(step, state.master, state.m, state.v), metrics


def _slices(t: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Views of ``t`` along its first dimension, each of at most
    ``SLICE_ELEMENTS`` elements where a row allows (``t`` itself when it
    is small or has no first dimension)."""
    if t.dim() == 0 or t.numel() <= SLICE_ELEMENTS:
        return (t,)
    rows = max(SLICE_ELEMENTS // (t.numel() // t.shape[0]), 1)
    return t.split(rows)
