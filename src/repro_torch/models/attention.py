"""GQA decode attention: the paged serving path and the contiguous oracle.

Ports the decode side of ``repro.models.attention`` at tp=1:

* ``paged_chunk_decode_attention`` — C query tokens per lane, KV written
  and attended through each lane's page table (the paged engine's step);
  attention goes to ``kernels.ops.paged_attention``, the CUDA kernel on a
  card and its plain version on the CPU.
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

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import head_geom, rmsnorm, rope

NEG_INF = -1e9


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
    caller already has it.  Returns y [B,C,D]; rows past ``n_new`` are
    garbage the caller discards.
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
    k_pool.view(-1, kv, hd)[dst] = k_new.reshape(-1, kv, hd)[rows]
    v_pool.view(-1, kv, hd)[dst] = v_new.reshape(-1, kv, hd)[rows]

    out = kops.paged_attention(q, k_pool, v_pool, page_table, pos, n_new)
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
    k_cache[lanes, pos.long()] = k_new[:, 0]
    v_cache[lanes, pos.long()] = v_new[:, 0]
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
