"""Prefill and decode: the full-sequence prefill, the contiguous
single-token step, the paged chunk step, their cache declarations, and
fused token selection.

Ports ``repro.models.decode``.  ``prefill`` and ``decode_step`` serve
every family (the hybrid's attention cache holds one layer per group, for
the shared block; vlm and encdec add a read-only cross cache of the
image's or the encoder's K/V projections, unroped); the
chunk steps (``decode_chunk`` over the dense per-slot cache, the gather
pathway's; ``decode_paged_chunk`` over the page pool) serve the families
with an attention cache, dense and moe.  A moe step routes every row of
its batch together, the rows it discards included (idle lanes, a decoding
lane's rows past its one, a prefill chunk's tail), so those rows are
computed as the reference computes them: they decide which live rows keep
their experts.
Layers run as a Python loop over the stacked ``[L, ...]`` weights (the
reference's ``lax.scan``); caches and pools are updated in place, so the
steps return only logits.

Sampling keeps the reference's semantics, not its bits: a lane's noise is
a pure function of ``(seed, rid, step)``, with no generator state, so a
request's stream does not depend on its slot, the schedule or preemption.
The noise comes from the port's own counter-based hash (``lane_gumbel``);
reproducing ``jax.random``'s threefry bits is not a goal.  Selection is
split so the two halves can be held to the reference separately:
``filter_logits`` (temperature, top-k, nucleus, exactly as the reference)
and ``select_tokens``, the Gumbel-argmax draw over given noise (in JAX,
``categorical(key, l)`` is ``argmax(l + gumbel(key))``).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as P
from repro_torch.models.attention import (chunk_decode_attention,
                                          cross_kv, decode_attention,
                                          dense_write_index, full_attention,
                                          paged_chunk_decode_attention,
                                          paged_write_index)
from repro_torch.models.layers import (embed_tokens, gelu_mlp, head_geom,
                                       logits_from, rmsnorm,
                                       sinusoidal_positions, swiglu)
from repro_torch.models.moe import moe_local
from repro_torch.models.ssm import conv_channels, mamba_block, mamba_decode
from repro_torch.models.stack import cross_block, encoder, gated

ATTENTION_CACHE = ("dense", "moe")


def _attention_cache_only(cfg: ModelConfig, what: str) -> None:
    if cfg.family not in ATTENTION_CACHE:
        raise ValueError(f"{what}: the chunk steps serve the families with "
                         f"an attention cache (dense, moe), got "
                         f"{cfg.family!r}")


def _ffn(cfg: ModelConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    """A dense or moe layer's FFN on its normed input (the moe aux, which
    serving discards, is not computed)."""
    if cfg.family == "moe":
        return moe_local(cfg, p["moe"], h, with_aux=False)[0]
    return swiglu(p["mlp"], h)


def _layer(layers: dict, i: int) -> dict:
    return P.tree_map(lambda a: a[i], layers)


# ================================================================= caches


def _kv_cache_spec(cfg: ModelConfig, layers: int, b: int, s: int) -> dict:
    geom = head_geom(cfg)
    shape = (layers, b, s, geom.n_kv, geom.head_dim)
    axes = ("layers", "cache_batch", "cache_seq", "cache_kv", None)
    return {"k": P.ParamSpec(shape, axes, init="zeros"),
            "v": P.ParamSpec(shape, axes, init="zeros")}


def _ssm_cache_spec(cfg: ModelConfig, layers: int, b: int) -> dict:
    return {
        "conv": P.ParamSpec((layers, b, cfg.conv_width - 1,
                             conv_channels(cfg)),
                            ("layers", "cache_batch", None, "act_inner"),
                            init="zeros"),
        "ssm": P.ParamSpec(
            (layers, b, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
            ("layers", "cache_batch", "cache_kv", None, None),
            torch.float32, init="zeros"),
    }


def _groups(cfg: ModelConfig) -> tuple[int, int]:
    """A hybrid's (groups, Mamba2 layers per group)."""
    return cfg.n_layers // cfg.attn_every, cfg.attn_every - 1


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> dict[str, Any]:
    """Per-slot caches of the contiguous engine: KV ``(layers, batch, seq,
    kv, hd)`` for dense and moe; conv tail ``(layers, batch, W-1, CC)``
    and fp32 SSM state ``(layers, batch, H, P, N)`` for ssm; both for
    hybrid, whose KV cache has one layer per group.  vlm and encdec add a
    ``cross`` KV cache, one layer per cross block, ``n_image_tokens`` or
    ``n_audio_frames`` long."""
    fam = cfg.family
    if fam in ATTENTION_CACHE:
        return {"self": _kv_cache_spec(cfg, cfg.n_layers, batch, seq_len)}
    if fam == "ssm":
        return {"ssm": _ssm_cache_spec(cfg, cfg.n_layers, batch)}
    if fam == "hybrid":
        groups, per = _groups(cfg)
        return {"ssm": _ssm_cache_spec(cfg, groups * per, batch),
                "self": _kv_cache_spec(cfg, groups, batch, seq_len)}
    if fam == "vlm":
        return {"self": _kv_cache_spec(cfg, cfg.n_layers, batch, seq_len),
                "cross": _kv_cache_spec(cfg, cfg.n_layers // cfg.cross_every,
                                        batch, cfg.n_image_tokens)}
    if fam == "encdec":
        return {"self": _kv_cache_spec(cfg, cfg.n_layers, batch, seq_len),
                "cross": _kv_cache_spec(cfg, cfg.n_layers, batch,
                                        cfg.n_audio_frames)}
    raise ValueError(f"cache_specs: unknown family {fam!r}")


def paged_cache_specs(cfg: ModelConfig, num_blocks: int,
                      block_size: int) -> dict[str, Any]:
    """The shared page pool ``(layers, num_blocks, block_size, kv, hd)``
    of the paged engine."""
    _attention_cache_only(cfg, "paged_cache_specs")
    geom = head_geom(cfg)
    shape = (cfg.n_layers, num_blocks, block_size, geom.n_kv, geom.head_dim)
    axes = ("layers", None, None, "cache_kv", None)
    return {"paged": {"k": P.ParamSpec(shape, axes, init="zeros"),
                      "v": P.ParamSpec(shape, axes, init="zeros")}}


# ================================================================== steps


@torch.no_grad()
def prefill(cfg: ModelConfig, params: dict, batch: dict,
            cache_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Full-sequence prefill: (last-position logits [B, Vpad] fp32, cache).
    The cache is the one ``cache_specs`` declares, KV rows for the prompt's
    positions (zero-padded to ``cache_len`` when it is longer: decode
    headroom), the SSM layers' conv tails and final states, and the cross
    blocks' K/V of the image embeddings or the encoder's states, as long
    as the context (never padded)."""
    fam = cfg.family
    x = embed_tokens(params["embed"], batch["tokens"])
    s = x.shape[1]
    eps = cfg.norm_eps

    def ssm_layer(x: torch.Tensor, i: int, convs: list, ssms: list):
        p = _layer(params["layers"], i)
        y, (conv, st) = mamba_block(cfg, p["mamba"], rmsnorm(p["ln"], x, eps),
                                    return_state=True)
        convs.append(conv)
        ssms.append(st)
        return x + y

    def self_attention(x: torch.Tensor, p: dict, h: torch.Tensor
                       ) -> torch.Tensor:
        a, (k, v) = full_attention(cfg, p, h, return_kv=True)
        ks.append(k)
        vs.append(v)
        return x + a

    def cross_cache(p: dict, ctx: torch.Tensor) -> None:
        ck, cv = cross_kv(cfg, p, ctx)
        cks.append(ck)
        cvs.append(cv)

    ks, vs, convs, ssms, cks, cvs = [], [], [], [], [], []
    if fam in ATTENTION_CACHE:
        for i in range(cfg.n_layers):
            p = _layer(params["layers"], i)
            x = self_attention(x, p["attn"], rmsnorm(p["ln1"], x, eps))
            x = x + _ffn(cfg, p, rmsnorm(p["ln2"], x, eps))
    elif fam == "ssm":
        for i in range(cfg.n_layers):
            x = ssm_layer(x, i, convs, ssms)
    elif fam == "hybrid":
        groups, per = _groups(cfg)
        shared = params["shared"]
        for g in range(groups):
            for j in range(per):
                x = ssm_layer(x, g * per + j, convs, ssms)
            h = rmsnorm(params["site_norm"][g],
                        rmsnorm(shared["ln_attn"], x, eps), eps)
            x = self_attention(x, shared["attn"], h)
            x = x + swiglu(shared["mlp"], rmsnorm(shared["ln_mlp"], x, eps))
    elif fam == "vlm":
        img = batch["image_embed"]
        per = cfg.cross_every
        for g in range(cfg.n_layers // per):
            cp = _layer(params["cross"], g)
            cross_cache(cp["attn"], img)
            x = cross_block(cfg, cp, x, img)
            for j in range(per):
                p = _layer(params["layers"], g * per + j)
                x = self_attention(x, p["attn"], rmsnorm(p["ln1"], x, eps))
                x = x + swiglu(p["mlp"], rmsnorm(p["ln2"], x, eps))
    elif fam == "encdec":
        enc = encoder(cfg, params, batch["audio_embed"])
        x = x + sinusoidal_positions(s, cfg.d_model, device=x.device)
        for i in range(cfg.n_layers):
            p = _layer(params["layers"], i)
            x = self_attention(x, p["self"], rmsnorm(p["ln1"], x, eps))
            cross_cache(p["cross"], enc)
            x = x + full_attention(cfg, p["cross"], rmsnorm(p["ln2"], x, eps),
                                   kv_x=enc, causal=False)
            x = x + gelu_mlp(p["mlp"], rmsnorm(p["ln3"], x, eps))
    else:
        raise ValueError(f"prefill: unknown family {fam!r}")

    cache: dict[str, Any] = {}
    if convs:
        cache["ssm"] = {"conv": torch.stack(convs), "ssm": torch.stack(ssms)}
    if ks:
        pad = (cache_len or s) - s
        cache["self"] = {
            name: torch.nn.functional.pad(torch.stack(t),
                                          (0, 0, 0, 0, 0, max(pad, 0)))
            for name, t in (("k", ks), ("v", vs))}
    if cks:
        cache["cross"] = {"k": torch.stack(cks), "v": torch.stack(cvs)}
    x = rmsnorm(params["final_norm"], x[:, -1:, :], eps)
    return logits_from(params["embed"], cfg, x)[:, 0], cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                token: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One-token decode.  token [B,1] int, pos [B] int.  Writes the cache
    in place (the cross cache is only read); returns logits [B, Vpad]
    fp32."""
    fam = cfg.family
    x = embed_tokens(params["embed"], token)
    eps = cfg.norm_eps

    def ssm_layer(x: torch.Tensor, i: int) -> torch.Tensor:
        p = _layer(params["layers"], i)
        return x + mamba_decode(cfg, p["mamba"], rmsnorm(p["ln"], x, eps),
                                cache["ssm"]["conv"][i],
                                cache["ssm"]["ssm"][i])

    if fam in ATTENTION_CACHE:
        kc, vc = cache["self"]["k"], cache["self"]["v"]
        for i in range(cfg.n_layers):
            p = _layer(params["layers"], i)
            h = rmsnorm(p["ln1"], x, eps)
            x = x + decode_attention(cfg, p["attn"], h, kc[i], vc[i], pos)
            x = x + _ffn(cfg, p, rmsnorm(p["ln2"], x, eps))
    elif fam == "ssm":
        for i in range(cfg.n_layers):
            x = ssm_layer(x, i)
    elif fam == "hybrid":
        groups, per = _groups(cfg)
        shared = params["shared"]
        kc, vc = cache["self"]["k"], cache["self"]["v"]
        for g in range(groups):
            for j in range(per):
                x = ssm_layer(x, g * per + j)
            h = rmsnorm(params["site_norm"][g],
                        rmsnorm(shared["ln_attn"], x, eps), eps)
            x = x + decode_attention(cfg, shared["attn"], h, kc[g], vc[g],
                                     pos)
            x = x + swiglu(shared["mlp"], rmsnorm(shared["ln_mlp"], x, eps))
    elif fam == "vlm":
        kc, vc = cache["self"]["k"], cache["self"]["v"]
        ck, cv = cache["cross"]["k"], cache["cross"]["v"]
        per = cfg.cross_every
        for g in range(cfg.n_layers // per):
            cp = _layer(params["cross"], g)
            h = rmsnorm(cp["ln"], x, eps)
            x = x + gated(cp["gate_attn"], decode_attention(
                cfg, cp["attn"], h, ck[g], cv[g], pos, update_cache=False))
            x = x + gated(cp["gate_mlp"], swiglu(
                cp["mlp"], rmsnorm(cp["ln_mlp"], x, eps)))
            for j in range(per):
                i = g * per + j
                p = _layer(params["layers"], i)
                h = rmsnorm(p["ln1"], x, eps)
                x = x + decode_attention(cfg, p["attn"], h, kc[i], vc[i], pos)
                x = x + swiglu(p["mlp"], rmsnorm(p["ln2"], x, eps))
    elif fam == "encdec":
        kc, vc = cache["self"]["k"], cache["self"]["v"]
        ck, cv = cache["cross"]["k"], cache["cross"]["v"]
        x = x + sinusoidal_positions(1, cfg.d_model,
                                     offset=pos[:, None])[:, None, :]
        for i in range(cfg.n_layers):
            p = _layer(params["layers"], i)
            h = rmsnorm(p["ln1"], x, eps)
            x = x + decode_attention(cfg, p["self"], h, kc[i], vc[i], pos)
            h = rmsnorm(p["ln2"], x, eps)
            x = x + decode_attention(cfg, p["cross"], h, ck[i], cv[i], pos,
                                     update_cache=False)
            x = x + gelu_mlp(p["mlp"], rmsnorm(p["ln3"], x, eps))
    else:
        raise ValueError(f"decode_step: unknown family {fam!r}")
    x = rmsnorm(params["final_norm"], x, eps)
    return logits_from(params["embed"], cfg, x)[:, 0]


@torch.no_grad()
def decode_chunk(cfg: ModelConfig, params: dict, cache: dict,
                 tokens: torch.Tensor, pos: torch.Tensor,
                 n_new: torch.Tensor) -> torch.Tensor:
    """C-token decode against the dense per-slot cache: the gather
    pathway's single step.

    tokens [B,C], pos [B] (first write position per lane), n_new [B] in
    [0, C] (0 idle lane, 1 decode tick, >1 prefill chunk); the cache is
    ``cache_specs``' ``{"self": {"k", "v"}}``, written in place.  Prefill
    lanes consume C prompt tokens per call while decode lanes advance one
    token in the same batched step.  Returns logits [B, Vpad] at each
    lane's last real position."""
    _attention_cache_only(cfg, "decode_chunk")
    b, c = tokens.shape
    x = embed_tokens(params["embed"], tokens)
    kc, vc = cache["self"]["k"], cache["self"]["v"]
    where = dense_write_index(pos, n_new, c, kc.shape[2])
    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i)
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        x = x + chunk_decode_attention(cfg, p["attn"], h, kc[i], vc[i], pos,
                                       n_new, write_index=where)
        x = x + _ffn(cfg, p, rmsnorm(p["ln2"], x, cfg.norm_eps))
    last = n_new.long().clamp(min=1) - 1
    x_last = x[torch.arange(b, device=x.device), last][:, None, :]
    x_last = rmsnorm(params["final_norm"], x_last, cfg.norm_eps)
    return logits_from(params["embed"], cfg, x_last)[:, 0]


@torch.no_grad()
def decode_paged_chunk(cfg: ModelConfig, params: dict, cache: dict,
                       tokens: torch.Tensor, pos: torch.Tensor,
                       n_new: torch.Tensor,
                       page_table: torch.Tensor) -> torch.Tensor:
    """C-token decode straight over the paged KV pool: the paged engine's
    single step.

    tokens [B,C], pos [B] (first write position per lane), n_new [B] in
    [0, C] (0 idle lane, 1 decode tick, >1 prefill chunk), page_table
    [B, n_pages] int32.  Fresh KV rows are written through the table and
    attention reads through it; no dense per-slot cache exists on this
    path.  Returns logits [B, Vpad] at each lane's last real position."""
    _attention_cache_only(cfg, "decode_paged_chunk")
    b, c = tokens.shape
    x = embed_tokens(params["embed"], tokens)
    kp, vp = cache["paged"]["k"], cache["paged"]["v"]
    where = paged_write_index(page_table, pos, n_new, c, kp.shape[2])
    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i)
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        x = x + paged_chunk_decode_attention(
            cfg, p["attn"], h, kp[i], vp[i], page_table, pos, n_new,
            write_index=where)
        x = x + _ffn(cfg, p, rmsnorm(p["ln2"], x, cfg.norm_eps))
    last = n_new.long().clamp(min=1) - 1
    x_last = x[torch.arange(b, device=x.device), last][:, None, :]
    x_last = rmsnorm(params["final_norm"], x_last, cfg.norm_eps)
    return logits_from(params["embed"], cfg, x_last)[:, 0]


# ========================================================= token selection

_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2**32`` for uint32 values held in int64, without
    overflowing int64 (16-bit halves)."""
    lo, hi = h & 0xFFFF, h >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & _M32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finaliser: a bijective avalanche mix."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def lane_gumbel(seed: torch.Tensor, rid: torch.Tensor, step: torch.Tensor,
                vocab: int) -> torch.Tensor:
    """Counter-based Gumbel noise ``[B, vocab]`` fp32: element ``(b, i)``
    is a hash of ``(seed[b], rid[b], step[b], i)``, so the draw for a
    request's ``step``-th token is the same on any engine, slot or
    schedule.  Integer ops only up to the final uniform, so a CPU and a GPU
    derive the same bits."""
    key = _mix32((seed.long() + 0x9E3779B9) & _M32)
    key = _mix32(key ^ (rid.long() & _M32))
    key = _mix32(key ^ (step.long() & _M32))
    idx = torch.arange(vocab, device=seed.device, dtype=torch.int64)
    bits = _mix32(key[:, None] ^ _mix32((idx + 0x7F4A7C15) & _M32))
    u = ((bits >> 8).float() + 0.5) * 2.0 ** -24          # in (0, 1)
    return -torch.log(-torch.log(u))


def filter_logits(logits: torch.Tensor, lane: dict[str, torch.Tensor]
                  ) -> torch.Tensor:
    """Temperature, top-k and nucleus filtering, exactly the reference's:
    one descending sort; the top-k cut keeps logits >= the k-th largest,
    the nucleus cut keeps the smallest set whose exclusive cumulative
    probability stays under ``top_p`` (``top_p >= 1`` bypasses it); the
    argmax survives both.  Returns the scaled logits, ``-inf`` where cut."""
    v = logits.shape[-1]
    scaled = logits.float() / lane["temperature"].clamp(min=1e-6)[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_eff = torch.where(lane["top_k"] > 0, lane["top_k"],
                        torch.full_like(lane["top_k"], v))
    kth = torch.gather(sorted_desc, 1,
                       (k_eff.long() - 1).clamp(0, v - 1)[:, None])
    probs = torch.softmax(sorted_desc, dim=-1)
    cum_excl = torch.cumsum(probs, dim=-1) - probs
    # top_p >= 1 means no nucleus cut at all: bypass the comparison so
    # float32 cumsum rounding can never mask extreme-tail tokens
    p_bound = torch.where(lane["top_p"] >= 1.0,
                          torch.full_like(lane["top_p"], float("inf")),
                          lane["top_p"])
    keep = cum_excl < p_bound[:, None]            # row 0 always True
    p_floor = torch.where(keep, sorted_desc,
                          torch.full_like(sorted_desc, float("inf"))
                          ).min(dim=-1, keepdim=True).values
    return torch.where((scaled >= kth) & (scaled >= p_floor), scaled,
                       torch.full_like(scaled, float("-inf")))


def select_tokens(logits: torch.Tensor, lane: dict[str, torch.Tensor],
                  noise: torch.Tensor) -> torch.Tensor:
    """Tokens ``[B]`` from logits ``[B, V]`` given Gumbel noise ``[B, V]``:
    exact argmax on greedy lanes (``temperature <= 0``), the Gumbel-argmax
    draw over the filtered logits elsewhere."""
    greedy = logits.float().argmax(dim=-1)
    sampled = (noise + filter_logits(logits, lane)).argmax(dim=-1)
    return torch.where(lane["temperature"] > 0.0, sampled, greedy)


def sample_from_logits(logits: torch.Tensor, lane: dict[str, torch.Tensor]
                       ) -> torch.Tensor:
    """Fused token selection with each lane's counter-based noise."""
    noise = lane_gumbel(lane["seed"], lane["rid"], lane["step"],
                        logits.shape[-1])
    return select_tokens(logits, lane, noise)
