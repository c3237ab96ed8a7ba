"""GQA attention: full-sequence attention (training, prefill, the
encoder, cross-attention) and the decode paths (the paged serving path and
the contiguous oracle).

Ports ``repro.models.attention``:

* ``full_attention`` — attention over whole sequences from position 0:
  causal or bidirectional self-attention, or cross-attention from ``x``
  to a context ``kv_x`` (image patches, encoder states).  Self-attention
  calls that meet the reference's flash condition go to
  ``kernels.ops.flash_attention`` (the CUDA kernel on a card, its plain
  version on the CPU), causal or not; the rest, cross-attention always,
  take the reference's q-chunked ``_attend``.  ``return_kv`` hands a
  prefill its cache rows.  Under a ``model`` axis of ``tp`` ranks
  (sequence-parallel training) each rank runs ``h_run / tp`` of the
  padded q heads (``HeadGeom(tp)``) through the same kernel: the
  sequence is gathered into the projections (``sp_col_projects``), K and
  V are projected whole and repeated to the q heads, and ``rs_project``
  reduce-scatters the output projection back to the sequence shards.
  The reference takes its Pallas kernel only at tp=1 under GSPMD and
  names ``shard_map`` deployments for the rest; the port's explicit
  collectives are such a deployment.  The decode paths run at tp=1.

* ``paged_chunk_decode_attention`` — C query tokens per lane, KV written
  and attended through each lane's page table (the paged engine's step);
  attention goes to ``kernels.ops.paged_attention``, the CUDA kernel on a
  card and its plain version on the CPU.
* ``chunk_decode_attention`` — C query tokens per lane against a dense
  per-slot cache (the paged engine's ``kernel="gather"`` pathway); plain
  torch ops, as the reference's jnp.
* ``decode_attention`` — one token against a dense per-slot cache (the
  contiguous ``ServeEngine``, the paged engine's oracle), or read-only
  against a cross-attention cache.

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
from repro_torch.models.layers import (HeadGeom, head_geom, pad_group_dim,
                                       rmsnorm, rope, rs_project,
                                       sp_col_projects)
from repro_torch.parallel import comm
from repro_torch.parallel.ctx import _current

NEG_INF = -1e9


def tp_size() -> int:
    ctx = _current()
    if ctx is None:
        return 1
    return ctx.axis_sizes.get("model", 1)


def _model_whole(w: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``w`` whole along ``dim`` (``size`` there): all-gathered over
    ``model`` where this rank holds a shard of it (reduce-scatter
    backward)."""
    if w.shape[dim] == size:
        return w
    return comm.all_gather(w, dim, _current().group(("model",)))


def _run_heads(w: torch.Tensor, geom: HeadGeom, axis_is_out: bool
               ) -> torch.Tensor:
    """This rank's ``h_run / tp`` padded q heads of ``wq`` (``axis_is_out``)
    or ``wo``.  Where the stored shard is those heads already (no padding,
    heads split evenly) it is used as it is; otherwise the heads are
    gathered whole, padded (``pad_group_dim``) and sliced."""
    dim = 1 if axis_is_out else 0
    width = geom.h_run // geom.tp * geom.head_dim
    if geom.g_pad == geom.group and w.shape[dim] == width:
        return w
    w = pad_group_dim(_model_whole(w, dim, geom.n_heads * geom.head_dim),
                      geom, axis_is_out)
    if geom.tp == 1:
        return w
    return w.narrow(dim, _current().coordinate(("model",)) * width, width)


def promoted_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in the two operands' common dtype, as ``jnp.matmul``
    promotes: a bf16 image embedding against f32 weights is an f32
    product."""
    dtype = torch.promote_types(a.dtype, w.dtype)
    return a.to(dtype) @ w.to(dtype)


def cross_kv(cfg: ModelConfig, p: dict, ctx: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """A context's raw key and value projections ``[B, Sk, KV, hd]``, with
    neither norm nor RoPE: a cross-attention cache's rows."""
    geom = head_geom(cfg)
    b, sk, _ = ctx.shape
    return (promoted_matmul(ctx, p["wk"]).reshape(b, sk, geom.n_kv,
                                                  geom.head_dim),
            promoted_matmul(ctx, p["wv"]).reshape(b, sk, geom.n_kv,
                                                  geom.head_dim))


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 geom: HeadGeom, kv_x: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Projections: q [B,S,h_run/tp,hd] (this rank's run heads) from ``x``,
    k and v [B,Sk,KV,hd] whole from ``kv_x`` (``x`` itself for
    self-attention), with the optional per-head q/k norm.  Self-attention
    fuses the sequence gather with all three projections; RoPE at
    positions ``0..S-1`` turns q, and k only in self-attention:
    cross-attention keys carry no position."""
    hd, kv = geom.head_dim, geom.n_kv
    wq = _run_heads(p["wq"], geom, axis_is_out=True)
    if kv_x is None:
        q, k, v = sp_col_projects(
            x, (wq, _model_whole(p["wk"], 1, kv * hd),
                _model_whole(p["wv"], 1, kv * hd)), ("act_heads", None, None))
    else:
        (q,) = sp_col_projects(x, (wq,), ("act_heads",))
        k, v = cross_kv(cfg, p, kv_x)
    b, s = q.shape[0], q.shape[1]
    q = q.reshape(b, s, -1, hd)
    if kv_x is None:
        k = k.reshape(b, s, kv, hd)
        v = v.reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_scale"], q, cfg.norm_eps)
        k = rmsnorm(p["k_scale"], k, cfg.norm_eps)
    if cfg.rope_theta > 0:
        pos = torch.arange(s, device=x.device)
        q = rope(q, pos, cfg.rope_theta)
        if kv_x is None:
            k = rope(k, pos, cfg.rope_theta)
    return q, k, v


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor | None, hd: int) -> torch.Tensor:
    """q [B,Sq,H,hd], k/v [B,Sk,H,hd] (kv repeated to the q heads) ->
    [B,Sq,H,hd].  fp32 scores and softmax; P rounded to v's dtype before
    P·V, as the reference's jnp path does.  ``mask`` None attends every
    key."""
    scores = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float())
    scores = scores * (hd ** -0.5)
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", probs, v)


def full_attention(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                   kv_x: torch.Tensor | None = None, causal: bool = True,
                   chunk: int = 1024, return_kv: bool = False):
    """Attention over whole sequences from position 0: x [B,S,D] -> y
    [B,S,D]; with ``return_kv`` also ``(k, v)`` [B,Sk,KV,hd] before the kv
    repeat (post-RoPE for self-attention), for a prefill's cache.
    Sequence-parallel, x and y are this rank's ``[B, S/tp, D]``.

    ``kv_x`` [B,Sk,D] makes it cross-attention: q from ``x`` at positions
    ``0..S-1``, k and v from ``kv_x`` unroped.  ``causal`` False attends
    every key (the encoder, cross-attention).

    kv is repeated to the padded q-head count, this rank's heads are kept,
    and every head runs as one row of a ``[B·h, S, hd]`` problem.  Where
    the reference would take its flash kernel (self-attention with
    ``S % min(128, S) == 0``; pos0 = 0 always holds here), the call goes
    to ``kops.flash_attention`` with ``causal`` as given, at any tp.  Other
    calls take ``_attend``, split into query chunks of ``chunk`` rows when
    S is a larger multiple of it, each chunk recomputed in the backward
    (the reference's remat of its scan body)."""
    geom = head_geom(cfg, tp_size())
    hd = geom.head_dim
    q, k, v = _project_qkv(cfg, p, x, geom, kv_x)
    b, s, h = q.shape[0], q.shape[1], q.shape[2]
    first = (_current().coordinate(("model",)) * h if geom.tp > 1 else 0)
    k_r = k.repeat_interleave(geom.g_pad, dim=2)[:, :, first:first + h]
    v_r = v.repeat_interleave(geom.g_pad, dim=2)[:, :, first:first + h]

    if kv_x is None and s % min(128, s) == 0:
        def heads_first(t):
            return t.transpose(1, 2).reshape(b * h, s, hd).contiguous()
        out = kops.flash_attention(heads_first(q), heads_first(k_r),
                                   heads_first(v_r), causal=causal)
        out = out.reshape(b, h, s, hd).transpose(1, 2)
    else:
        pos = torch.arange(s, device=x.device)
        k_pos = torch.arange(k.shape[1], device=x.device)

        def block(q_blk: torch.Tensor, q_pos: torch.Tensor) -> torch.Tensor:
            mask = ((k_pos[None, :] <= q_pos[:, None])[None, None]
                    if causal else None)
            return _attend(q_blk, k_r, v_r, mask, hd)

        if s > chunk and s % chunk == 0:
            out = torch.cat([checkpoint(block, q[:, i:i + chunk],
                                        pos[i:i + chunk], use_reentrant=False)
                             for i in range(0, s, chunk)], dim=1)
        else:
            out = block(q, pos)
    y = rs_project(out.reshape(b, s, h * hd),
                   _run_heads(p["wo"], geom, axis_is_out=False), "act_heads")
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
                     pos: torch.Tensor, *,
                     update_cache: bool = True) -> torch.Tensor:
    """Single-token decode: x [B,1,D]; caches [B,Smax,KV,hd]; pos [B].
    Writes the token's K/V in place at ``pos`` and attends rows up to it;
    with ``update_cache`` False the caches are read only and every row is
    attended (cross-attention: q still turns at ``pos``).  Returns
    y [B,1,D]."""
    geom = head_geom(cfg)
    hd, kv, g = geom.head_dim, geom.n_kv, geom.group
    b = x.shape[0]
    s_max = k_cache.shape[1]

    q = (x @ p["wq"]).reshape(b, 1, kv, g, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_scale"], q, cfg.norm_eps)
    if cfg.rope_theta > 0:
        q = rope(q.reshape(b, 1, kv * g, hd), pos[:, None],
                 cfg.rope_theta).reshape(b, 1, kv, g, hd)

    if update_cache:
        k_new = (x @ p["wk"]).reshape(b, 1, kv, hd)
        v_new = (x @ p["wv"]).reshape(b, 1, kv, hd)
        if cfg.qk_norm:
            k_new = rmsnorm(p["k_scale"], k_new, cfg.norm_eps)
        if cfg.rope_theta > 0:
            k_new = rope(k_new, pos[:, None], cfg.rope_theta)
        lanes = torch.arange(b, device=x.device)
        k_cache[lanes, pos.long()] = k_new[:, 0].to(k_cache.dtype)
        v_cache[lanes, pos.long()] = v_new[:, 0].to(v_cache.dtype)
    scores = torch.einsum("bkgh,bskh->bkgs", q[:, 0].float(),
                          k_cache.float()) * (hd ** -0.5)
    if update_cache:
        valid = torch.arange(s_max, device=x.device)[None, :] <= pos[:, None]
        scores = torch.where(valid[:, None, None, :], scores,
                             torch.full_like(scores, NEG_INF))
    # fp32 softmax weights, one rounding after the P·V product
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", probs,
                       v_cache.float()).to(x.dtype)
    return out.reshape(b, 1, kv * g * hd) @ p["wo"]
