"""Mixture-of-Experts FFN: top-k routing and capacity-bounded, sort-based
dispatch, at tensor-parallel width 1.

Ports ``repro.models.moe``: ``moe_specs``, ``_capacity`` and the tp=1 body
of ``_moe_local`` (the two ``all_to_all`` transports of expert parallelism
wait for the multi-GPU slice), as a function on tensors.  All ``B*S`` rows
of a call are routed together under one capacity, ``int(n * k * cf / E)``
slots an expert: the rows are sorted by expert (stably, so earlier rows
win slots), a row past its expert's capacity is dropped from that expert,
and the kept rows are copied into ``[E, cap, D]`` slots.  So every row of a
call, the dead rows of a serving chunk included, can take a slot from
another; the paged kernel computes those rows as the plain version does
(``kernels.ops.paged_attention(..., all_rows=True)``) for that reason.

The expert products ``ecd,edf->ecf`` are ``torch.bmm`` over all experts,
empty slots included, as in the reference (which computes them outside any
Pallas kernel).  Rounding points follow the reference: the router in fp32,
``top_w`` cast to ``x.dtype``, each token's weighted expert outputs summed
in ``x.dtype`` from zero in the reference's scatter order.

Under ``torch.profiler`` the three stages run in the spans ``moe_route``
(router, top-k, aux and dispatch), ``moe_experts`` (the expert products)
and ``moe_combine``; with no profiler running no span is opened.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as P
from repro_torch.models.layers import silu


def moe_specs(cfg: ModelConfig, layers: int | None) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    lyr = (layers,) if layers is not None else ()
    lax_ = ("layers",) if layers is not None else ()
    return {
        "router": P.ParamSpec(lyr + (d, e), lax_ + ("embed", None),
                              torch.float32),
        "gate": P.ParamSpec(lyr + (e, d, f), lax_ + ("experts", "embed", "mlp")),
        "up": P.ParamSpec(lyr + (e, d, f), lax_ + ("experts", "embed", "mlp")),
        "down": P.ParamSpec(lyr + (e, f, d), lax_ + ("experts", "mlp", "embed")),
    }


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    cap = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(cap, 1)


def _span(name: str):
    """A ``record_function`` span while a profiler runs, else nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


@contextlib.contextmanager
def _ieee_fp32():
    """fp32 products without TF32 inside the block: a TF32 router rounds
    its logits to 10 mantissa bits and flips top-k choices."""
    flag = torch.backends.cuda.matmul.allow_tf32
    if flag:
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        if flag:
            torch.backends.cuda.matmul.allow_tf32 = True


def moe_local(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
              with_aux: bool = True
              ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """x [B, S, D] -> (y [B, S, D], aux [B, S] fp32, or None when
    ``with_aux`` is off: the decode steps discard it)."""
    b, s, d = x.shape
    n = b * s
    with _span("moe_route"):
        disp, aux, dest, order, top_w = _route(cfg, p, x.reshape(n, d), b, s,
                                               with_aux)
    with _span("moe_experts"):
        h = silu(torch.bmm(disp, p["gate"])) * torch.bmm(disp, p["up"])
        y_e = torch.bmm(h, p["down"])                          # [E, cap, D]
    with _span("moe_combine"):
        y = _combine(y_e, dest, order, top_w, n, cfg.top_k)
    return y.reshape(b, s, d), aux


def _route(cfg: ModelConfig, p: dict, xf: torch.Tensor, b: int, s: int,
           with_aux: bool):
    """Router, top-k, aux and dispatch of ``xf`` [n, D]: (the dispatched
    rows [E, cap, D], aux or None, each sorted entry's slot ``dest`` (E*cap
    where dropped), the sort ``order`` and the combine weights ``top_w``
    [n, k])."""
    e, k = cfg.n_experts, cfg.top_k
    n, d = xf.shape
    with _ieee_fp32():
        logits = xf.float() @ p["router"]                      # [n, E]
    probs = torch.softmax(logits, dim=-1)
    # torch.topk returns the k largest in descending order; the order of
    # equal probabilities is unspecified (jax.lax.top_k puts the lower
    # expert first).  fp32 probabilities of a continuous router do not tie.
    top_p, top_i = torch.topk(probs, k, dim=-1)                # [n, k]
    top_w = (top_p / top_p.sum(dim=-1, keepdim=True)).to(xf.dtype)

    aux = None
    if with_aux:
        # load-balancing aux (Switch): E * sum_e f_e * p_e
        assign = torch.zeros(n, e, dtype=torch.float32, device=xf.device)
        assign.scatter_(1, top_i, 1.0)
        f_e = assign.mean(dim=0) / k
        p_e = probs.mean(dim=0)
        aux = (e * (f_e * p_e).sum()).expand(b, s)

    # sort-based capacity dispatch: the stable sort (jnp.argsort's) keeps
    # each expert's rows in token order, so earlier rows win its slots
    cap = _capacity(n, cfg)
    flat_e = top_i.reshape(-1)                                 # [n*k]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_e = torch.arange(n * k, device=xf.device) - first
    keep = pos_in_e < cap
    dest = torch.where(keep, sorted_e * cap + pos_in_e,
                       torch.full_like(sorted_e, e * cap))
    # kept rows land on distinct slots; every dropped row, zeroed, on the
    # overflow slot E*cap, which is cut off
    xs = xf[order // k] * keep[:, None].to(xf.dtype)
    disp = torch.zeros(e * cap + 1, d, dtype=xf.dtype, device=xf.device)
    disp = disp.index_put((dest,), xs)
    return disp[:-1].reshape(e, cap, d), aux, dest, order, top_w


def _combine(y_e: torch.Tensor, dest: torch.Tensor, order: torch.Tensor,
             top_w: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """Each token's k weighted expert outputs [n, D], without atomics: its
    entries in sorted order (by expert, then stable), summed in the
    outputs' dtype from zero, as the reference's
    ``zeros.at[token_of].add(gathered)`` does."""
    e, cap, d = y_e.shape
    slots = torch.cat([y_e.reshape(e * cap, d),
                       torch.zeros(1, d, dtype=y_e.dtype, device=y_e.device)])
    gathered = slots[dest] * top_w.reshape(-1)[order][:, None]  # sorted order
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n * k, device=y_e.device)
    parts = gathered[rank.reshape(n, k).sort(dim=1).values]    # [n, k, D]
    y = torch.zeros(n, d, dtype=y_e.dtype, device=y_e.device)
    for j in range(k):
        y = y + parts[:, j]
    return y


# At tp=1 the reference's ``moe_ffn`` is its local body: no expert
# parallelism, no all_to_all.
moe_ffn = moe_local
