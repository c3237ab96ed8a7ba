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

Under a bound mesh (the training step's: dense, moe, ssm and hybrid)
each rank runs its shards: ``P.gathered`` all-gathers each layer's FSDP
dimensions inside the layer's remat (so the backward gathers them again),
the residual stream between blocks is this rank's ``[B/dp, S/tp, D]``
(``res``: the reference's ``act_res`` sequence sharding, checked by
``constrain``), and ``moe_aux`` is the mean over every rank's shard.  A
Mamba2 layer takes its weights whole (``P.whole``) into
``ssm.mamba_block_cp``, the context-parallel block; zamba2's shared block
gathers the shared weights at each use and runs attention and SwiGLU
tensor-parallel, as a dense layer does.  vlm and encdec raise there:
their blocks have no sharded form in the port yet.
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
from repro_torch.models.ssm import cp_refusal, mamba_block_cp
from repro_torch.parallel import comm
from repro_torch.parallel.ctx import (_axes, _current, carry, constrain,
                                      resolve)

# the slice of the port that will shard each other family's blocks
_CROSS = "vlm and encdec under a mesh"
UNSHARDED = {"vlm": _CROSS, "encdec": _CROSS}


def _remat(fn: Callable, mode: str) -> Callable:
    """``full`` recomputes each layer in the backward from its input (the
    reference's ``nothing_saveable``), under the sharding context of the
    forward (``carry``).  ``dots`` maps to ``none``: the
    reference's policy saves every matmul output and recomputes only the
    elementwise ops, which PyTorch's checkpoint cannot select; the values
    are the same either way, only the memory differs."""
    if mode in ("none", "dots"):
        return fn
    if mode == "full":
        return lambda *args: checkpoint(carry(fn), *args, use_reentrant=False)
    raise ValueError(f"unknown remat mode {mode}")


def _dense_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = x + full_attention(cfg, p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps))
    return h + swiglu(p["mlp"], rmsnorm(p["ln2"], h, cfg.norm_eps))


def _moe_block(cfg: ModelConfig, p: dict, x: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    h = x + full_attention(cfg, p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps))
    y, aux = moe_ffn(cfg, p["moe"], rmsnorm(p["ln2"], h, cfg.norm_eps))
    return h + y, aux.mean()


def _ssm_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return x + mamba_block_cp(cfg, p["mamba"],
                              rmsnorm(p["ln"], x, cfg.norm_eps))


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


def check_mesh(cfg: ModelConfig, rows: int, seq: int) -> None:
    """Raise ``ValueError`` unless the bound mesh can run ``cfg``'s step on
    ``rows`` local batch rows of ``seq`` tokens as the reference shards
    it: dense, moe, ssm and hybrid; a ``model`` axis only with the
    residual stream sequence-sharded (``act_res``) and the sequence,
    ``d_ff``, the vocab and the experts split evenly over it, and for ssm
    and hybrid the context-parallel block's condition (``cp_refusal``);
    the batch split over the data axes.  Where the reference would
    replicate an uneven dimension or the scan, the port refuses rather
    than replicate quietly."""
    ctx = _current()
    if ctx is None or ctx.mesh.size() == 1:
        return
    if cfg.family in UNSHARDED:
        raise ValueError(
            f"{cfg.name} ({cfg.family}) has no sharded step in the port: a "
            f"mesh of {tuple(ctx.mesh.shape)} waits for the slice that "
            f"ports {UNSHARDED[cfg.family]}")
    tp = ctx.axis_sizes.get("model", 1)
    dp = tuple(a for a in ctx.mesh.mesh_dim_names if a != "model")
    batch = rows * ctx.size(dp)
    want = dp if len(dp) > 1 else dp[0] if dp else None
    if ctx.size(dp) > 1 and resolve(("act_batch", "act_seq"),
                                    (batch, seq))[0] != want:
        raise ValueError(f"a batch of {batch} does not split over {dp}")
    if tp == 1:
        return
    if ctx.rules.get("act_res") != "model" or seq % tp:
        raise ValueError(
            f"a model axis of {tp} shards the step only with the residual "
            f"stream sequence-sharded over it (rules with act_res=model, "
            f"a sequence that splits): seq {seq}")
    if cfg.family in ("ssm", "hybrid"):
        why = cp_refusal(cfg, seq, tp)
        if why is not None:
            raise ValueError(f"{cfg.name} on a mesh of "
                             f"{tuple(ctx.mesh.shape)}: {why}")
    for spec in P.leaves(P.param_specs(cfg)):
        even = resolve(spec.axes, spec.shape)
        for name, part, kept in zip(spec.axes, resolve(spec.axes), even):
            if (name in ("mlp", "vocab", "experts")
                    and "model" in _axes(part) and kept is None):
                raise ValueError(f"{name} of {spec.shape} does not split "
                                 f"over a model axis of {tp}")


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            remat: str = "none") -> tuple[torch.Tensor, dict]:
    """Full-sequence forward -> (logits [B,S,Vpad] fp32, metrics); under a
    bound mesh, this rank's rows (and, sequence-parallel, its vocab
    columns)."""
    fam = cfg.family
    if fam not in ("dense", "moe", "ssm", "hybrid", "vlm", "encdec"):
        raise ValueError(f"unknown family {fam!r} ({cfg.name})")
    rows, seq = batch["tokens"].shape
    check_mesh(cfg, rows, seq)
    if fam == "encdec":
        return _encdec_forward(cfg, params, batch, remat)
    ctx = _current()
    specs = P.param_specs(cfg) if ctx is not None else {}
    dp = ([a for a in ctx.mesh.mesh_dim_names if a != "model"]
          if ctx is not None else [])
    res_shape = (rows * (ctx.size(dp) if ctx is not None else 1), seq,
                 cfg.d_model)

    def res(x: torch.Tensor) -> torch.Tensor:
        # the reference also pins the cotangent to bf16 here; autograd
        # keeps every gradient in its tensor's dtype already, so no pin
        return constrain(x, ("act_batch", "act_res", None), res_shape)

    def layer_tree(p: dict) -> dict:
        if fam in ("ssm", "hybrid"):    # ln has no sharded dimension
            return P.whole(p, specs.get("layers"), stacked=True)
        return P.gathered(p, specs.get("layers"), stacked=True)

    metrics: dict[str, torch.Tensor] = {}
    embed = P.gathered(params["embed"], specs.get("embed"))
    x = res(embed_tokens(embed, batch["tokens"]))
    per_layer = _unbind_layers(params["layers"])

    if fam == "moe":
        body = _remat(lambda x, p: _moe_block(cfg, layer_tree(p), x), remat)
        auxes = []
        for i in range(cfg.n_layers):
            x, aux = body(x, per_layer(i))
            x = res(x)
            auxes.append(aux)
        aux = torch.stack(auxes).mean()
        if ctx is not None:
            aux = comm.all_reduce(aux, ctx.group(ctx.mesh.mesh_dim_names)
                                  ) / ctx.mesh.size()
        metrics["moe_aux"] = aux
    elif fam == "vlm":
        img = batch["image_embed"]
        body = _remat(lambda x, p: _dense_block(cfg, p, x), remat)
        cross_layer = _unbind_layers(params["cross"])
        cross = _remat(lambda x, p: cross_block(cfg, p, x, img), remat)
        per = cfg.cross_every
        for g in range(cfg.n_layers // per):
            x = cross(x, cross_layer(g))
            for j in range(per):
                x = body(x, per_layer(g * per + j))
    elif fam != "hybrid":
        block = _dense_block if fam == "dense" else _ssm_block
        body = _remat(lambda x, p: block(cfg, layer_tree(p), x), remat)
        for i in range(cfg.n_layers):
            x = res(body(x, per_layer(i)))
    else:
        body = _remat(lambda x, p: _ssm_block(cfg, layer_tree(p), x), remat)
        groups = cfg.n_layers // cfg.attn_every
        per = cfg.attn_every - 1

        def shared_block(x: torch.Tensor, sn: torch.Tensor) -> torch.Tensor:
            # the shared weights gathered at each use, each group's site
            # norm's gradient summed over the ranks
            return _shared_block(
                cfg, P.gathered(params["shared"], specs.get("shared")),
                P.gathered(sn, specs.get("site_norm"), stacked=True), x)
        shared = _remat(shared_block, remat)
        site_norms = params["site_norm"].unbind(0)
        for g in range(groups):
            for j in range(per):
                x = res(body(x, per_layer(g * per + j)))
            x = res(shared(x, site_norms[g]))
    x = rmsnorm(P.gathered(params["final_norm"], specs.get("final_norm")),
                x, cfg.norm_eps)
    return logits_from(embed, cfg, x), metrics
