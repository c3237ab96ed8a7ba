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
port's attention caches are (the reference returns new arrays).  The
context-parallel ``mamba_block_cp`` waits for the multi-GPU slice; at one
device the reference's falls through to ``mamba_block``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ssd_scan import (  # noqa: F401  (re-export)
    ssd_scan_plain as ssd_chunked)
from repro_torch.models import params as P
from repro_torch.models.layers import rmsnorm, silu


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
