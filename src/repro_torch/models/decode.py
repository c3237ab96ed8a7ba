"""Decode steps of the dense family: the paged chunk step, the contiguous
single-token step, their cache declarations, and fused token selection.

Ports the dense branches of ``repro.models.decode``.  Layers run as a
Python loop over the stacked ``[L, ...]`` weights (the reference's
``lax.scan``); caches and pools are updated in place, so the steps return
only logits.

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
from repro_torch.models.attention import (decode_attention,
                                          paged_chunk_decode_attention,
                                          paged_write_index)
from repro_torch.models.layers import (embed_tokens, head_geom, logits_from,
                                       rmsnorm, swiglu)


def _dense_only(cfg: ModelConfig, what: str) -> None:
    if cfg.family != "dense":
        raise ValueError(f"{what}: the port serves the dense family only, "
                         f"got {cfg.family!r}")


def _layer(layers: dict, i: int) -> dict:
    return P.tree_map(lambda a: a[i], layers)


# ================================================================= caches


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> dict[str, Any]:
    """Dense per-slot KV cache ``(layers, batch, seq, kv, hd)`` for the
    contiguous engine."""
    _dense_only(cfg, "cache_specs")
    geom = head_geom(cfg)
    shape = (cfg.n_layers, batch, seq_len, geom.n_kv, geom.head_dim)
    axes = ("layers", "cache_batch", "cache_seq", "cache_kv", None)
    return {"self": {"k": P.ParamSpec(shape, axes, init="zeros"),
                     "v": P.ParamSpec(shape, axes, init="zeros")}}


def paged_cache_specs(cfg: ModelConfig, num_blocks: int,
                      block_size: int) -> dict[str, Any]:
    """The shared page pool ``(layers, num_blocks, block_size, kv, hd)``
    of the paged engine."""
    _dense_only(cfg, "paged_cache_specs")
    geom = head_geom(cfg)
    shape = (cfg.n_layers, num_blocks, block_size, geom.n_kv, geom.head_dim)
    axes = ("layers", None, None, "cache_kv", None)
    return {"paged": {"k": P.ParamSpec(shape, axes, init="zeros"),
                      "v": P.ParamSpec(shape, axes, init="zeros")}}


# ================================================================== steps


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                token: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One-token decode.  token [B,1] int, pos [B] int.  Writes the cache
    in place; returns logits [B, Vpad] fp32."""
    _dense_only(cfg, "decode_step")
    x = embed_tokens(params["embed"], token)
    kc, vc = cache["self"]["k"], cache["self"]["v"]
    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i)
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        x = x + decode_attention(cfg, p["attn"], h, kc[i], vc[i], pos)
        x = x + swiglu(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_from(params["embed"], cfg, x)[:, 0]


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
    _dense_only(cfg, "decode_paged_chunk")
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
        x = x + swiglu(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps))
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
