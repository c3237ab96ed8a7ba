"""GQA attention: full-sequence self-attention (training) and the decode
paths (the paged serving path and the contiguous oracle).

Ports ``repro.models.attention`` at tp=1:

* ``full_attention`` — causal self-attention over whole sequences from
  position 0, as the dense stack calls it.  Calls that meet the
  reference's flash condition go to ``kernels.ops.flash_attention`` (the
  CUDA kernel on a card, its plain version on the CPU); the rest take the
  reference's q-chunked ``_attend``.  Cross-attention, non-causal
  (encoder) attention and ``pos0 > 0`` wait for the vlm/encdec slice;
  ``return_kv`` hands a prefill its cache rows.

* ``paged_chunk_decode_attention`` — C query tokens per lane, KV written
  and attended through each lane's page table (the paged engine's step);
  attention goes to ``kernels.ops.paged_attention``, the CUDA kernel on a
  card and its plain version on the CPU.
* ``chunk_decode_attention`` — C query tokens per lane against a dense
  per-slot cache (the paged engine's ``kernel="gather"`` pathway); plain
  torch ops, as the reference's jnp.
* ``decode_attention`` — one token against a dense per-slot cache (the
  contiguous ``ServeEngine``, the paged engine's oracle).

Caches and pools are updated **in place** (the reference returns new
arrays, which JAX donates and re-adopts); these functions return only the
attention output.  Softmax weights stay fp32 and the P·V product rounds
once, as in the reference, so every decode pathway rounds at the same
points.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import head_geom, rmsnorm, rope

NEG_INF = -1e9


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 pos: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Self-attention projections: q [B,S,H,hd], k and v [B,S,KV,hd], with
    the optional per-head q/k norm and RoPE at positions ``pos`` [S]."""
    geom = head_geom(cfg)
    hd, kv = geom.head_dim, geom.n_kv
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, geom.h_run, hd)
    k = (x @ p["wk"]).reshape(b, s, kv, hd)
    v = (x @ p["wv"]).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_scale"], q, cfg.norm_eps)
        k = rmsnorm(p["k_scale"], k, cfg.norm_eps)
    if cfg.rope_theta > 0:
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    return q, k, v


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor, hd: int) -> torch.Tensor:
    """q [B,Sq,H,hd], k/v [B,Sk,H,hd] (kv repeated to the q heads) ->
    [B,Sq,H,hd].  fp32 scores and softmax; P rounded to v's dtype before
    P·V, as the reference's jnp path does."""
    scores = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float())
    scores = scores * (hd ** -0.5)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", probs, v)


def full_attention(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                   chunk: int = 1024, return_kv: bool = False):
    """Causal self-attention over whole sequences from position 0:
    x [B,S,D] -> y [B,S,D]; with ``return_kv`` also the post-RoPE
    ``(k, v)`` [B,S,KV,hd] before the kv repeat, for a prefill's cache.

    kv is repeated to the q-head count and every head runs as one row of a
    ``[B·H, S, hd]`` problem.  Where the reference would take its flash
    kernel (``S % min(128, S) == 0``; pos0 = 0, self-attention and tp = 1
    always hold here), the call goes to ``kops.flash_attention``.  Other
    lengths take ``_attend``, split into query chunks of ``chunk`` rows
    when S is a larger multiple of it, each chunk recomputed in the
    backward (the reference's remat of its scan body)."""
    geom = head_geom(cfg)
    hd, h = geom.head_dim, geom.h_run
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, pos)
    k_r = k.repeat_interleave(geom.g_pad, dim=2)
    v_r = v.repeat_interleave(geom.g_pad, dim=2)

    if s % min(128, s) == 0:
        def heads_first(t):
            return t.transpose(1, 2).reshape(b * h, s, hd).contiguous()
        out = kops.flash_attention(heads_first(q), heads_first(k_r),
                                   heads_first(v_r), causal=True)
        out = out.reshape(b, h, s, hd).transpose(1, 2)
    else:
        def block(q_blk: torch.Tensor, q_pos: torch.Tensor) -> torch.Tensor:
            mask = (pos[None, :] <= q_pos[:, None])[None, None]
            return _attend(q_blk, k_r, v_r, mask, hd)

        if s > chunk and s % chunk == 0:
            out = torch.cat([checkpoint(block, q[:, i:i + chunk],
                                        pos[i:i + chunk], use_reentrant=False)
                             for i in range(0, s, chunk)], dim=1)
        else:
            out = block(q, pos)
    y = out.reshape(b, s, h * hd) @ p["wo"]
    return (y, (k, v)) if return_kv else y


def dense_write_index(pos: torch.Tensor, n_new: torch.Tensor, chunk: int,
                      s_max: int) -> tuple[torch.Tensor, ...]:
    """Where a chunk's fresh KV rows go in the dense per-slot cache:
    ``(lane, col, row)``, the lane and chunk column of each row to write
    and its cache row ``pos + col``.  A lane writes only its first
    ``n_new`` rows, and none past ``s_max``: the rest are masked out here,
    where the reference sends them past the cache with ``mode="drop"``.
    Every layer of a step writes the same rows, so the decode step
    computes this once (one host sync) for all layers."""
    steps = torch.arange(chunk, device=pos.device)
    idx = pos[:, None].long() + steps[None, :]                    # [B, C]
    ok = (steps[None, :] < n_new[:, None]) & (idx < s_max)
    lane, col = ok.nonzero(as_tuple=True)
    return lane, col, idx[lane, col]


def chunk_decode_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                           k_cache: torch.Tensor, v_cache: torch.Tensor,
                           pos: torch.Tensor, n_new: torch.Tensor, *,
                           write_index: tuple | None = None
                           ) -> torch.Tensor:
    """Multi-token decode against the dense cache (the gather pathway's
    chunked prefill / decode mix).

    x [B,C,D]; caches [B,Smax,KV,hd] (written in place); pos [B] each
    lane's first write position; n_new [B] in [0, C] its real tokens.
    Query i of a lane attends cache rows j <= pos + i, so a chunk is
    causally exact against the rows already cached and against itself.
    ``write_index`` is ``dense_write_index``'s result when the caller
    already has it.  Returns y [B,C,D]; rows past ``n_new`` are garbage the
    caller discards.
    """
    geom = head_geom(cfg)
    hd, kv, g = geom.head_dim, geom.n_kv, geom.group
    b, c, _ = x.shape
    s_max = k_cache.shape[1]

    q = (x @ p["wq"]).reshape(b, c, kv, g, hd)
    k_new = (x @ p["wk"]).reshape(b, c, kv, hd)
    v_new = (x @ p["wv"]).reshape(b, c, kv, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_scale"], q, cfg.norm_eps)
        k_new = rmsnorm(p["k_scale"], k_new, cfg.norm_eps)
    idx = pos[:, None] + torch.arange(c, device=x.device)[None, :]  # [B,C]
    if cfg.rope_theta > 0:
        q = rope(q.reshape(b, c, kv * g, hd), idx,
                 cfg.rope_theta).reshape(b, c, kv, g, hd)
        k_new = rope(k_new, idx, cfg.rope_theta)

    lane, col, row = (write_index if write_index is not None else
                      dense_write_index(pos, n_new, c, s_max))
    # the cache's dtype, as the reference's ``.at[].set`` casts
    k_cache[lane, row] = k_new[lane, col].to(k_cache.dtype)
    v_cache[lane, row] = v_new[lane, col].to(v_cache.dtype)

    scores = torch.einsum("bckgh,bskh->bkgcs", q.float(),
                          k_cache.float()) * (hd ** -0.5)
    valid = (torch.arange(s_max, device=x.device)[None, None, :]
             <= idx[:, :, None])                                   # [B,C,S]
    scores = torch.where(valid[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    # fp32 softmax weights, one rounding after the P·V product
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgcs,bskh->bckgh", probs,
                       v_cache.float()).to(x.dtype)
    return out.reshape(b, c, kv * g * hd) @ p["wo"]


def paged_write_index(page_table: torch.Tensor, pos: torch.Tensor,
                      n_new: torch.Tensor, chunk: int, block_size: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Where a chunk's fresh KV rows go in the pool: ``(rows, dst)``, the
    flat ``[B*C]`` indices of the rows to write and their flat pool rows
    ``page * block_size + offset``.

    Row ``idx = pos + i`` lands in physical page ``table[idx // bs]`` at
    offset ``idx % bs``.  A lane writes only its first ``n_new`` rows, and
    never past its table: the rest (idle lanes, padding rows) are masked
    out here, where the reference sends them to page ``num_blocks`` with
    ``mode="drop"``.  Every layer of a step writes the same rows, so the
    decode step computes this once (one host sync) for all layers."""
    n_pages = page_table.shape[1]
    steps = torch.arange(chunk, device=pos.device)
    idx = pos[:, None].long() + steps[None, :]                    # [B, C]
    ok = (steps[None, :] < n_new[:, None]) & (idx < n_pages * block_size)
    blk = (idx // block_size).clamp(0, n_pages - 1)
    page = torch.gather(page_table.long(), 1, blk)
    flat = page * block_size + idx % block_size
    rows = ok.flatten().nonzero().squeeze(1)
    return rows, flat.flatten()[rows]


def paged_chunk_decode_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                                 k_pool: torch.Tensor, v_pool: torch.Tensor,
                                 page_table: torch.Tensor, pos: torch.Tensor,
                                 n_new: torch.Tensor, *,
                                 write_index: tuple | None = None
                                 ) -> torch.Tensor:
    """Chunked decode straight over the paged KV pool.

    x [B,C,D]; k/v_pool [num_blocks, block_size, KV, hd] (one layer of the
    shared page pool, contiguous); page_table [B, n_pages] int32; pos [B]
    each lane's first write position; n_new [B] in [0, C] its real tokens.

    The fresh K/V rows are scattered into the pool through the page table
    (into each lane's private pages only: shared prefix pages are whole
    blocks below ``pos``), then every page is attended through the same
    table.  ``write_index`` is ``paged_write_index``'s result when the
    caller already has it.  Returns y [B,C,D].  For the dense family rows
    past ``n_new`` are garbage the caller discards; a moe layer routes
    every row of the batch together, so there the kernel computes every
    row as the plain version does (``all_rows``): a dead row decides which
    live rows keep their experts.
    """
    geom = head_geom(cfg)
    hd, kv, g = geom.head_dim, geom.n_kv, geom.group
    b, c, _ = x.shape
    bs = k_pool.shape[1]

    q = (x @ p["wq"]).reshape(b, c, kv, g, hd)
    k_new = (x @ p["wk"]).reshape(b, c, kv, hd)
    v_new = (x @ p["wv"]).reshape(b, c, kv, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_scale"], q, cfg.norm_eps)
        k_new = rmsnorm(p["k_scale"], k_new, cfg.norm_eps)
    if cfg.rope_theta > 0:
        idx = pos[:, None] + torch.arange(c, device=x.device)[None, :]
        q = rope(q.reshape(b, c, kv * g, hd), idx,
                 cfg.rope_theta).reshape(b, c, kv, g, hd)
        k_new = rope(k_new, idx, cfg.rope_theta)

    rows, dst = (write_index if write_index is not None else
                 paged_write_index(page_table, pos, n_new, c, bs))
    k_pool.view(-1, kv, hd)[dst] = k_new.reshape(-1, kv, hd)[rows].to(
        k_pool.dtype)
    v_pool.view(-1, kv, hd)[dst] = v_new.reshape(-1, kv, hd)[rows].to(
        v_pool.dtype)

    out = kops.paged_attention(q, k_pool, v_pool, page_table, pos, n_new,
                               all_rows=cfg.family == "moe")
    return out.reshape(b, c, kv * g * hd) @ p["wo"]


def decode_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """Single-token decode: x [B,1,D]; caches [B,Smax,KV,hd] (written in
    place at ``pos``); pos [B].  Returns y [B,1,D]."""
    geom = head_geom(cfg)
    hd, kv, g = geom.head_dim, geom.n_kv, geom.group
    b = x.shape[0]
    s_max = k_cache.shape[1]

    q = (x @ p["wq"]).reshape(b, 1, kv, g, hd)
    k_new = (x @ p["wk"]).reshape(b, 1, kv, hd)
    v_new = (x @ p["wv"]).reshape(b, 1, kv, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_scale"], q, cfg.norm_eps)
        k_new = rmsnorm(p["k_scale"], k_new, cfg.norm_eps)
    if cfg.rope_theta > 0:
        posb = pos[:, None]
        q = rope(q.reshape(b, 1, kv * g, hd), posb,
                 cfg.rope_theta).reshape(b, 1, kv, g, hd)
        k_new = rope(k_new, posb, cfg.rope_theta)

    lanes = torch.arange(b, device=x.device)
    k_cache[lanes, pos.long()] = k_new[:, 0].to(k_cache.dtype)
    v_cache[lanes, pos.long()] = v_new[:, 0].to(v_cache.dtype)
    valid = torch.arange(s_max, device=x.device)[None, :] <= pos[:, None]

    scores = torch.einsum("bkgh,bskh->bkgs", q[:, 0].float(),
                          k_cache.float()) * (hd ** -0.5)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    # fp32 softmax weights, one rounding after the P·V product
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", probs,
                       v_cache.float()).to(x.dtype)
    return out.reshape(b, 1, kv * g * hd) @ p["wo"]
