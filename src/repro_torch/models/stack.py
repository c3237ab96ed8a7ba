"""Per-family block stacks: the full-sequence forward for training.

Ports the dense, moe, ssm and hybrid branches of
``repro.models.stack.forward``: embed, then

* dense  — per layer [RMSNorm, self-attention, residual, RMSNorm, SwiGLU,
  residual];
* moe    — the same with the MoE FFN in place of SwiGLU; ``metrics``
  carries ``moe_aux``, the mean over layers of each layer's
  load-balancing aux;
* ssm    — per layer [RMSNorm, Mamba2, residual];
* hybrid — per group, ``attn_every - 1`` Mamba2 layers, then the one
  globally shared attention + SwiGLU block behind the group's site norm
  (zamba2);

then the final norm and fp32 logits over the padded vocab.  The reference
scans over the stacked ``[L, ...]`` layer parameters; here a Python loop
walks them, each leaf split once with ``unbind`` so the backward stacks
the layers' gradients in one step.  Remat wraps each layer, and each call
of the shared block, as the reference's scans do.  vlm and encdec are
later slices.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as P
from repro_torch.models.attention import full_attention
from repro_torch.models.layers import (embed_tokens, logits_from, rmsnorm,
                                       swiglu)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.ssm import mamba_block


def _remat(fn: Callable, mode: str) -> Callable:
    """``full`` recomputes each layer in the backward from its input (the
    reference's ``nothing_saveable``).  ``dots`` maps to ``none``: the
    reference's policy saves every matmul output and recomputes only the
    elementwise ops, which PyTorch's checkpoint cannot select; the values
    are the same either way, only the memory differs."""
    if mode in ("none", "dots"):
        return fn
    if mode == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    raise ValueError(f"unknown remat mode {mode}")


def _dense_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    # The reference's ``_res`` (a sharding constraint and a pin of the
    # cotangent to bf16) is the identity here: at tp=1 nothing is sharded,
    # and a gradient in PyTorch already takes its tensor's dtype.
    h = x + full_attention(cfg, p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps))
    return h + swiglu(p["mlp"], rmsnorm(p["ln2"], h, cfg.norm_eps))


def _moe_block(cfg: ModelConfig, p: dict, x: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    h = x + full_attention(cfg, p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps))
    y, aux = moe_ffn(cfg, p["moe"], rmsnorm(p["ln2"], h, cfg.norm_eps))
    return h + y, aux.mean()


def _ssm_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return x + mamba_block(cfg, p["mamba"], rmsnorm(p["ln"], x, cfg.norm_eps))


def _shared_block(cfg: ModelConfig, p: dict, site_norm: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    h = x + full_attention(
        cfg, p["attn"],
        rmsnorm(site_norm, rmsnorm(p["ln_attn"], x, cfg.norm_eps),
                cfg.norm_eps))
    return h + swiglu(p["mlp"], rmsnorm(p["ln_mlp"], h, cfg.norm_eps))


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            remat: str = "none") -> tuple[torch.Tensor, dict]:
    """Full-sequence forward -> (logits [B,S,Vpad] fp32, metrics)."""
    fam = cfg.family
    if fam not in ("dense", "moe", "ssm", "hybrid"):
        raise ValueError(f"the port's stack runs the dense, moe, ssm and "
                         f"hybrid families, got {fam!r} ({cfg.name})")
    metrics: dict[str, torch.Tensor] = {}
    x = embed_tokens(params["embed"], batch["tokens"])
    per_layer = P.tree_map(lambda t: t.unbind(0), params["layers"])

    def layer(i: int) -> dict:
        return P.tree_map(lambda ts: ts[i], per_layer)

    if fam == "moe":
        body = _remat(lambda x, p: _moe_block(cfg, p, x), remat)
        auxes = []
        for i in range(cfg.n_layers):
            x, aux = body(x, layer(i))
            auxes.append(aux)
        metrics["moe_aux"] = torch.stack(auxes).mean()
    elif fam != "hybrid":
        block = _dense_block if fam == "dense" else _ssm_block
        body = _remat(lambda x, p: block(cfg, p, x), remat)
        for i in range(cfg.n_layers):
            x = body(x, layer(i))
    else:
        body = _remat(lambda x, p: _ssm_block(cfg, p, x), remat)
        groups = cfg.n_layers // cfg.attn_every
        per = cfg.attn_every - 1
        shared = _remat(lambda x, sn: _shared_block(cfg, params["shared"],
                                                    sn, x), remat)
        site_norms = params["site_norm"].unbind(0)
        for g in range(groups):
            for j in range(per):
                x = body(x, layer(g * per + j))
            x = shared(x, site_norms[g])
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_from(params["embed"], cfg, x), metrics
