"""Mamba2 (SSD, state-space duality) block at tensor-parallel width 1.

Ports ``repro.models.ssm``: the parameter declaration, the depthwise causal
conv, the full-sequence block (training and prefill) and the one-token
decode step.  The chunked scan goes to ``kernels.ops.ssd_scan``: the CUDA
kernel on a card, its plain version (``ssd_chunked``, the reference's
``ssd_chunked`` in torch ops) on the CPU.  Per-op roundings follow the
reference: the projections and the conv in the weights' dtype (bf16),
``silu`` as the reference's chain of bf16 ops, ``softplus`` on fp32,
``d_skip`` cast to x's dtype, and the gated RMSNorm over ``y * silu(z)``.

``mamba_decode`` updates the conv and SSM state **in place**, as the
port's attention caches are (the reference returns new arrays).

``mamba_block_cp`` is the reference's context-parallel block: under a
``model`` axis of ``tp`` ranks whose residual stream is sequence-sharded
(the ``train`` rules), each rank runs the whole block (weights whole,
``params.whole``) on its ``S / tp`` tokens.  The causal conv takes its
``W - 1``-token halo from the previous rank (``comm.shift``, a send and a
receive), the local scan starts from zero through ``kops.ssd_scan`` (the
CUDA kernel on a card), and the incoming state comes from every earlier
rank's final state and total decay (``comm.all_gather``, ``_cp_prefix``):
the recurrence is linear in its initial state, so the prefix's
contribution is added after the scan.  With no ``model`` axis it is
``mamba_block``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ssd_scan import (  # noqa: F401  (re-export)
    ssd_scan_plain as ssd_chunked)
from repro_torch.models import params as P
from repro_torch.models.layers import rmsnorm, silu
from repro_torch.parallel import comm
from repro_torch.parallel.ctx import _current


def conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def ssm_specs(cfg: ModelConfig, layers: int | None) -> dict:
    d, di, h = cfg.d_model, cfg.d_inner, cfg.n_ssm_heads
    cc = conv_channels(cfg)
    lyr = (layers,) if layers is not None else ()
    lax_ = ("layers",) if layers is not None else ()

    def spec(shape, axes, **kw):
        return P.ParamSpec(lyr + shape, lax_ + axes, **kw)

    f32 = torch.float32
    return {
        "wz": P.dense(d, di, "embed", "ssm_inner", layers),
        "wxbc": P.dense(d, cc, "embed", "ssm_inner", layers),
        "wdt": P.dense(d, h, "embed", "ssm_heads", layers),
        "conv_w": spec((cfg.conv_width, cc), (None, "ssm_inner")),
        "conv_b": spec((cc,), ("ssm_inner",), init="zeros"),
        "a_log": spec((h,), ("ssm_heads",), dtype=f32, init="zeros"),
        "d_skip": spec((h,), ("ssm_heads",), dtype=f32, init="ones"),
        "dt_bias": spec((h,), ("ssm_heads",), dtype=f32, init="zeros"),
        "norm": P.scale(di, layers),
        "out": P.dense(di, d, "ssm_inner", "embed", layers),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it:
    ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def causal_conv(w: torch.Tensor, b: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv by tap shifts.  x [B,S,C]; w [W,C]; b [C]."""
    width, s = w.shape[0], x.shape[1]
    out = x * w[-1] + b
    for k in range(1, width):
        shifted = torch.nn.functional.pad(x, (0, 0, k, 0))[:, :s]
        out = out + shifted * w[-1 - k]
    return out


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    a: torch.Tensor, b_in: torch.Tensor, c_in: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD update.  state [B,H,P,N] fp32, x [B,H,P], dt [B,H],
    b_in/c_in [B,G,N].  Returns (y [B,H,P] in x's dtype, new_state)."""
    hg = x.shape[1] // b_in.shape[1]
    bh = b_in.repeat_interleave(hg, dim=1).float()            # [B,H,N]
    ch = c_in.repeat_interleave(hg, dim=1).float()
    dtf = dt.float()
    da = torch.exp(dtf * a)                                   # [B,H]
    upd = (dtf[..., None] * x.float())[..., None] * bh[:, :, None, :]
    new_state = state * da[..., None, None] + upd             # [B,H,P,N]
    y = torch.einsum("bhpn,bhn->bhp", new_state, ch).to(x.dtype)
    return y, new_state


def _split(cfg: ModelConfig, xbc: torch.Tensor, lead: tuple[int, ...]):
    """xbc [..., CC] -> x [*lead, H, P], B and C [*lead, G, N]."""
    di, n, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    xc = xbc[..., :di].reshape(*lead, cfg.n_ssm_heads, cfg.ssm_head_dim)
    b_in = xbc[..., di:di + g * n].reshape(*lead, g, n)
    c_in = xbc[..., di + g * n:].reshape(*lead, g, n)
    return xc, b_in, c_in


def mamba_block(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                return_state: bool = False):
    """Full-sequence Mamba2 block.  x [B,S,D] -> y [B,S,D].  With
    ``return_state``: (y, (conv_tail [B,W-1,CC], ssm_state [B,H,P,N]))."""
    bsz, s, _ = x.shape
    z = x @ p["wz"]
    xbc_pre = x @ p["wxbc"]
    dt = softplus((x @ p["wdt"]).float() + p["dt_bias"])
    xbc = silu(causal_conv(p["conv_w"], p["conv_b"], xbc_pre))
    xc, b_in, c_in = _split(cfg, xbc, (bsz, s))
    a = -torch.exp(p["a_log"])
    y, final = kops.ssd_scan(xc.contiguous(), dt, a, b_in.contiguous(),
                             c_in.contiguous(), cfg.ssd_chunk)
    y = y + xc * p["d_skip"][None, None, :, None].to(x.dtype)
    y = y.reshape(bsz, s, cfg.d_inner) * silu(z)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    out = y @ p["out"]
    if return_state:
        return out, (xbc_pre[:, s - (cfg.conv_width - 1):, :], final)
    return out


def mamba_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 conv_state: torch.Tensor,
                 ssm_state: torch.Tensor) -> torch.Tensor:
    """One-token Mamba2 step.  x [B,1,D]; conv_state [B,W-1,CC] and
    ssm_state [B,H,P,N] are advanced in place.  Returns y [B,1,D]."""
    bsz = x.shape[0]
    x1 = x[:, 0]
    z = x1 @ p["wz"]
    xbc = x1 @ p["wxbc"]
    dt = softplus((x1 @ p["wdt"]).float() + p["dt_bias"])
    window = torch.cat([conv_state, xbc[:, None, :]], dim=1)  # [B,W,CC]
    conv = torch.einsum("bwc,wc->bc", window, p["conv_w"]) + p["conv_b"]
    conv_state.copy_(window[:, 1:])
    xc, b_in, c_in = _split(cfg, silu(conv), (bsz,))
    a = -torch.exp(p["a_log"])
    y, new_ssm = ssd_decode_step(ssm_state, xc, dt, a, b_in, c_in)
    ssm_state.copy_(new_ssm)
    y = y + xc * p["d_skip"][None, :, None].to(x.dtype)
    y = y.reshape(bsz, cfg.d_inner) * silu(z)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    return (y @ p["out"])[:, None, :]


# ======================================================================
# Context-parallel SSD (the sequence-sharded Mamba2 block)
#
# Left to a partitioner, the inter-chunk recurrence over a sequence-
# sharded scan replicates the whole [B, n_chunks, H, P, N] state tensor
# (the reference measured 640 MiB of all-reduce and all-gather a layer on
# mamba2-2.7b at 32k tokens).  Here every rank keeps its tokens and
# exchanges only a (W-1)-token halo (send/recv), one [tp, B, H, P, N]
# state summary and [tp, B, H] decays (all-gathers), beside the weights.
# ======================================================================


def cp_refusal(cfg: ModelConfig, seq: int, tp: int) -> str | None:
    """Why ``mamba_block_cp`` cannot shard a sequence of ``seq`` tokens
    over a ``model`` axis of ``tp`` ranks (the reference's condition, past
    which it falls back to replicating the scan), or ``None`` where it
    can."""
    if seq % tp:
        return (f"mamba_block_cp needs the sequence to split over the model "
                f"axis: seq {seq} over {tp} ranks")
    s_loc = seq // tp
    chunk = min(cfg.ssd_chunk, s_loc)
    if s_loc % chunk:
        return (f"mamba_block_cp needs each rank's {s_loc} tokens to be a "
                f"multiple of its scan chunk min(ssd_chunk {cfg.ssd_chunk}, "
                f"{s_loc}) = {chunk}: seq {seq} over {tp} ranks")
    if s_loc < cfg.conv_width - 1:
        return (f"mamba_block_cp needs each rank's {s_loc} tokens to hold "
                f"the conv's {cfg.conv_width - 1}-token halo")
    return None


def _cp_prefix(s_all: torch.Tensor, d_all: torch.Tensor, my_idx: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Incoming prefix state for shard ``my_idx``, and the global final
    state.  s_all [tp,B,H,P,N] zero-init final states; d_all [tp,B,H]
    total decays.  prefix_i = sum_{j<i} s_j * prod_{j<k<i} d_k.

    Every shard's prefix is stacked and this one's taken, as the
    reference does: so every rank's gradient reaches ``s_all`` and
    ``d_all``, and every rank joins their all-gathers' reduce-scatters
    (rank 0's prefix alone is the zero state, and its backward would skip
    them while the others wait)."""
    acc = torch.zeros_like(s_all[0])
    incoming = []
    for j in range(s_all.shape[0]):
        incoming.append(acc)
        acc = acc * d_all[j][..., None, None] + s_all[j]
    return torch.stack(incoming)[my_idx], acc


def _mamba_cp_body(cfg: ModelConfig, group, tp: int, idx: int,
                   return_state: bool, p: dict, x: torch.Tensor):
    """One rank's block.  x [b_loc, s_loc, D], this rank's sequence shard
    (rank ``idx`` of ``group``, the ``model`` axis); ``p`` whole."""
    bsz, s_loc, _ = x.shape
    w, h, g = cfg.conv_width, cfg.n_ssm_heads, cfg.ssm_groups
    z = x @ p["wz"]
    xbc_pre = x @ p["wxbc"]
    dt = softplus((x @ p["wdt"]).float() + p["dt_bias"])

    # causal conv with the previous shard's tail as its left halo, its
    # taps summed in ``causal_conv``'s order (so a bf16 shard rounds as the
    # unsharded block does; the reference's body adds them the other way)
    halo = comm.shift(xbc_pre[:, s_loc - (w - 1):, :], group)
    full = torch.cat([halo, xbc_pre], dim=1)        # [b, s_loc+w-1, CC]
    conv = xbc_pre * p["conv_w"][-1] + p["conv_b"]
    for k in range(1, w):
        tap = full[:, w - 1 - k:w - 1 - k + s_loc, :]   # x[t - k]
        conv = conv + tap * p["conv_w"][-1 - k]
    xc, b_in, c_in = _split(cfg, silu(conv), (bsz, s_loc))
    a = -torch.exp(p["a_log"])

    # local zero-init scan, then the cross-shard prefix's contribution
    y0, s_local = kops.ssd_scan(xc.contiguous(), dt, a, b_in.contiguous(),
                                c_in.contiguous(),
                                min(cfg.ssd_chunk, s_loc))
    da = dt * a                                     # [b, s_loc, h] fp32
    total_decay = torch.exp(da.sum(dim=1))          # [b, h]
    s_all = comm.all_gather(s_local[None], 0, group)         # [tp,b,h,p,n]
    d_all = comm.all_gather(total_decay[None], 0, group)     # [tp,b,h]
    s_in, s_global = _cp_prefix(s_all, d_all, idx)
    decay_t = torch.exp(torch.cumsum(da, dim=1))    # [b, s_loc, h]
    c_h = c_in.float().repeat_interleave(h // g, dim=2)      # [b,s,h,n]
    y_corr = torch.einsum("bshn,bsh,bhpn->bshp", c_h, decay_t, s_in)
    y = y0 + y_corr.to(y0.dtype)

    y = y + xc * p["d_skip"][None, None, :, None].to(x.dtype)
    y = y.reshape(bsz, s_loc, cfg.d_inner) * silu(z)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    out = y @ p["out"]
    if not return_state:
        return out
    # the last shard's conv tail and the global final state, on every rank
    tails = comm.all_gather(full[:, -(w - 1):, :][None], 0, group)
    return out, (tails[tp - 1], s_global)


def mamba_block_cp(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                   return_state: bool = False):
    """The context-parallel Mamba2 block on this rank's sequence shard x
    [B/dp, S/tp, D], ``p`` whole on every rank (``params.whole``), under a
    bound ``model`` axis of ``tp`` ranks with the residual stream
    sequence-sharded over it (``act_res``).  Without such an axis (none
    bound, or one rank) it is ``mamba_block``.  Where the reference's
    condition fails under one (``cp_refusal``), it raises ``ValueError``:
    the reference replicates the scan there, which the port does not do
    quietly.  ``return_state``: the conv tail and final state of the whole
    sequence, on every rank; where they enter a loss, they enter it on
    every rank of the axis (with a zero cotangent where they do not
    count), so every rank's backward joins the all-gathers' transposes."""
    ctx = _current()
    tp = ctx.axis_sizes.get("model", 1) if ctx is not None else 1
    if tp == 1:
        return mamba_block(cfg, p, x, return_state=return_state)
    why = (cp_refusal(cfg, x.shape[1] * tp, tp)
           if ctx.rules.get("act_res") == "model" else
           "mamba_block_cp needs the residual stream sequence-sharded over "
           "the model axis (rules with act_res=model)")
    if why is not None:
        raise ValueError(why)
    return _mamba_cp_body(cfg, ctx.group(("model",)), tp,
                          ctx.coordinate(("model",)), return_state, p, x)
