"""Per-family block stacks: the full-sequence forward for training.

Ports ``repro.models.stack.forward``: embed, then

* dense  — per layer [RMSNorm, self-attention, residual, RMSNorm, SwiGLU,
  residual];
* moe    — the same with the MoE FFN in place of SwiGLU; ``metrics``
  carries ``moe_aux``, the mean over layers of each layer's
  load-balancing aux;
* ssm    — per layer [RMSNorm, Mamba2, residual];
* hybrid — per group, ``attn_every - 1`` Mamba2 layers, then the one
  globally shared attention + SwiGLU block behind the group's site norm
  (zamba2);
* vlm    — per group, one gated cross-attention block over the image
  embeddings (``tanh(gate)`` scales its attention and its SwiGLU), then
  ``cross_every`` dense layers (llama-3.2-vision);

then the final norm and fp32 logits over the padded vocab.  encdec
(whisper) runs an encoder first — sinusoidal positions on the audio
embeddings, per layer bidirectional self-attention and a GELU MLP, a final
norm — then the decoder: token embeddings plus sinusoidal positions, per
layer causal self-attention, cross-attention to the encoder's output and
a GELU MLP.  The reference
scans over the stacked ``[L, ...]`` layer parameters; here a Python loop
walks them, each leaf split once with ``unbind`` so the backward stacks
the layers' gradients in one step.  Remat wraps each layer, each call of
the shared block and each cross block, as the reference's scans do.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as P
from repro_torch.models.attention import full_attention
from repro_torch.models.layers import (embed_tokens, gelu_mlp, logits_from,
                                       rmsnorm, sinusoidal_positions, swiglu)
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


def gated(gate: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``tanh(gate)`` (fp32) cast to ``h``'s dtype, times ``h``: the
    reference's rounding order."""
    return torch.tanh(gate).to(h.dtype) * h


def cross_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 ctx: torch.Tensor) -> torch.Tensor:
    h = full_attention(cfg, p["attn"], rmsnorm(p["ln"], x, cfg.norm_eps),
                       kv_x=ctx, causal=False)
    x = x + gated(p["gate_attn"], h)
    m = swiglu(p["mlp"], rmsnorm(p["ln_mlp"], x, cfg.norm_eps))
    return x + gated(p["gate_mlp"], m)


def _unbind_layers(layers: dict) -> Callable[[int], dict]:
    """Layer ``i`` of a stacked ``[L, ...]`` tree, each leaf split once."""
    per_layer = P.tree_map(lambda t: t.unbind(0), layers)
    return lambda i: P.tree_map(lambda ts: ts[i], per_layer)


def _encoder_block(cfg: ModelConfig, p: dict, x: torch.Tensor
                   ) -> torch.Tensor:
    h = x + full_attention(cfg, p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                           causal=False)
    return h + gelu_mlp(p["mlp"], rmsnorm(p["ln2"], h, cfg.norm_eps))


def encoder(cfg: ModelConfig, params: dict, audio_embed: torch.Tensor,
            remat: str = "none") -> torch.Tensor:
    """The encdec encoder: audio embeddings [B,S,D] -> normed states."""
    x = audio_embed + sinusoidal_positions(audio_embed.shape[1], cfg.d_model,
                                           device=audio_embed.device)
    layer = _unbind_layers(params["enc_layers"])
    body = _remat(lambda x, p: _encoder_block(cfg, p, x), remat)
    for i in range(cfg.n_encoder_layers):
        x = body(x, layer(i))
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _decoder_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                   enc: torch.Tensor) -> torch.Tensor:
    h = x + full_attention(cfg, p["self"], rmsnorm(p["ln1"], x, cfg.norm_eps))
    h = h + full_attention(cfg, p["cross"], rmsnorm(p["ln2"], h, cfg.norm_eps),
                           kv_x=enc, causal=False)
    return h + gelu_mlp(p["mlp"], rmsnorm(p["ln3"], h, cfg.norm_eps))


def _encdec_forward(cfg: ModelConfig, params: dict, batch: dict,
                    remat: str) -> tuple[torch.Tensor, dict]:
    enc = encoder(cfg, params, batch["audio_embed"], remat)
    x = embed_tokens(params["embed"], batch["tokens"])
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model, device=x.device)
    layer = _unbind_layers(params["layers"])
    body = _remat(lambda x, p: _decoder_block(cfg, p, x, enc), remat)
    for i in range(cfg.n_layers):
        x = body(x, layer(i))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_from(params["embed"], cfg, x), {}


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            remat: str = "none") -> tuple[torch.Tensor, dict]:
    """Full-sequence forward -> (logits [B,S,Vpad] fp32, metrics)."""
    fam = cfg.family
    if fam == "encdec":
        return _encdec_forward(cfg, params, batch, remat)
    if fam not in ("dense", "moe", "ssm", "hybrid", "vlm"):
        raise ValueError(f"unknown family {fam!r} ({cfg.name})")
    metrics: dict[str, torch.Tensor] = {}
    x = embed_tokens(params["embed"], batch["tokens"])
    layer = _unbind_layers(params["layers"])

    if fam == "moe":
        body = _remat(lambda x, p: _moe_block(cfg, p, x), remat)
        auxes = []
        for i in range(cfg.n_layers):
            x, aux = body(x, layer(i))
            auxes.append(aux)
        metrics["moe_aux"] = torch.stack(auxes).mean()
    elif fam == "vlm":
        img = batch["image_embed"]
        body = _remat(lambda x, p: _dense_block(cfg, p, x), remat)
        cross_layer = _unbind_layers(params["cross"])
        cross = _remat(lambda x, p: cross_block(cfg, p, x, img), remat)
        per = cfg.cross_every
        for g in range(cfg.n_layers // per):
            x = cross(x, cross_layer(g))
            for j in range(per):
                x = body(x, layer(g * per + j))
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
