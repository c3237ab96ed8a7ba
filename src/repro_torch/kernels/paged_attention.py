"""Decode attention through the device page table: the CUDA kernel's
wrapper and its plain PyTorch version.

Port of ``repro.kernels.paged_attention``.  The TPU kernel
(``paged_attention_pallas``, body ``_paged_kernel``) becomes the hand-written
CUDA kernel in ``csrc/paged_attention.cu`` (its header says how it is laid
out and what bounds it); ``paged_attention_cuda`` checks the arguments and
launches it on the current stream.  ``paged_attention_plain`` mirrors the
reference's ``paged_attention_ref``: a dense gather through the page table
and a full fp32 softmax.  ``kernels.ops.paged_attention`` picks between
the two by the tensors' device.

The kernel is bound by the bytes of K/V it must read.  It splits each
lane's pages across blocks (``paged_splits`` of them, so the card's SMs
fill several times over), reads every page once for all of a kv head's
query rows, and merges the splits' fp32 partials in split order in a second
launch, through a workspace of ``paged_workspace_elements`` floats that the
wrapper allocates (none with one split).  It has two designs, picked by
the arguments before the launch (``paged_design``): bf16 with a head dim
that is a multiple of 16 up to 128 and at least ``MMA_MIN_ROWS`` query rows
a kv head (``C * G``) runs its products on the tensor cores (``"mma"``);
f32, other head dims and fewer rows run as fp32 FMAs on the CUDA cores
(``"scalar"``).  Nothing is retried on the other design.  Where a tensor-core
block's live rows fit one warp's 16 (a GQA group decoding one row of the
engine's chunk), its warps split the keys instead of the rows.

Shapes (the reference's layout):
  q          [B, C, KV, G, hd]  post-RoPE queries, bf16 or f32
  k/v_pool   [num_blocks, block_size, KV, hd]  one layer of the page pool,
             already holding this call's fresh rows
  page_table [B, n_pages] int32  physical page per logical block; entries
             past a lane's allocation hold a valid index (0), masked
  pos, n_new [B] int32  rows already cached / fresh rows this call
Output [B, C, KV, G, hd].  Row ``r`` of a lane attends the keys up to
``pos + r`` through the whole table; the plain version computes every row
so, idle lanes included.  The kernel computes the rows below
``max(n_new, 1)`` and writes the rest as zeros (the dense family discards
them), or, with ``all_rows``, every row as the plain version does: a moe
layer routes all of a chunk's rows together, so there a discarded row
decides which live rows keep their experts.
"""
from __future__ import annotations

import ctypes
import functools

import torch

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MMA_MIN_ROWS = 4      # query rows a (lane, kv head) needs for the tensor cores
MMA_MAX_HEAD_DIM = 128
# the split of a lane's pages (``pages_per_split`` in the kernel source)
MAX_ROWS = 128        # query rows a block holds
SCALAR_ACC = 16384    # rows x head_dim of a scalar block's fp32 accumulator
TARGET_BLOCKS = 1056  # 8 blocks on each of an H100's 132 SMs
KEYS_PER_ROW = 8      # least keys a split reads per query row
MAX_PAGES_PER_SPLIT = 1024


@functools.cache
def paged_design(dtype: torch.dtype, c: int, g: int, hd: int) -> str:
    """The design the kernel takes for q's dtype, chunk, GQA group and head
    dim: ``"mma"`` (``mma.sync`` on the tensor cores: bf16, hd a multiple
    of 16 up to 128, at least ``MMA_MIN_ROWS`` rows ``c * g`` a kv head)
    or ``"scalar"`` (fp32 FMAs on the CUDA cores).  Mirrors
    ``paged_attention_design`` in ``csrc/paged_attention.cu``."""
    mma = (dtype == torch.bfloat16 and hd % 16 == 0
           and 16 <= hd <= MMA_MAX_HEAD_DIM and c * g >= MMA_MIN_ROWS)
    return "mma" if mma else "scalar"


@functools.cache
def paged_splits(b: int, c: int, kv: int, g: int, hd: int, bs: int,
                 n_pages: int, dtype: torch.dtype) -> int:
    """Blocks a lane's pages are split over (the kernel's grid.y): enough
    that about ``TARGET_BLOCKS`` blocks fill the card, few enough that a
    split reads at least ``KEYS_PER_ROW`` keys per query row of a block.
    Mirrors ``paged_attention_splits`` in ``csrc/paged_attention.cu``."""
    r = c * g
    rows = min(r, MAX_ROWS if paged_design(dtype, c, g, hd) == "mma"
               else min(MAX_ROWS, SCALAR_ACC // hd))
    units = b * kv * -(-r // rows)          # blocks a split, over row groups
    want = min(-(-TARGET_BLOCKS // units), n_pages)
    pps = max(-(-n_pages // want), -(-KEYS_PER_ROW * rows // bs),
              -(-n_pages // 65535))
    pps = min(pps, MAX_PAGES_PER_SPLIT, n_pages)
    return -(-n_pages // pps)


@functools.cache
def paged_workspace_elements(b: int, c: int, kv: int, g: int, hd: int,
                             bs: int, n_pages: int,
                             dtype: torch.dtype) -> int:
    """fp32 elements of the workspace a launch needs: each split's partial
    accumulator ``[B*KV, splits, C*G, hd]`` and its ``(m, l)`` pairs; none
    with one split.  Equals ``paged_attention_workspace_floats`` in
    ``csrc/paged_attention.cu``."""
    n = paged_splits(b, c, kv, g, hd, bs, n_pages, dtype)
    return 0 if n < 2 else b * kv * n * c * g * (hd + 2)


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, page_table: torch.Tensor,
                          pos: torch.Tensor, n_new: torch.Tensor
                          ) -> torch.Tensor:
    """Plain PyTorch version: gather every table page, mask, full fp32
    softmax, P·V in fp32, one cast; every row of every lane, row ``r``
    seeing the keys up to ``pos + r`` (the reference's
    ``paged_attention_ref``).  Mathematically the kernel's function on the
    rows it computes: the live ones, or all of them with ``all_rows``."""
    b, c, kv, g, hd = q.shape
    bs = k_pool.shape[1]
    n_pages = page_table.shape[1]
    scale = hd ** -0.5
    idx = page_table.long()
    k = k_pool[idx].reshape(b, n_pages * bs, kv, hd)
    v = v_pool[idx].reshape(b, n_pages * bs, kv, hd)
    s = torch.einsum("bckgh,bskh->bkgcs", q.float(), k.float()) * scale
    rows = pos[:, None].long() + torch.arange(c, device=q.device)[None, :]
    keys = torch.arange(n_pages * bs, device=q.device)
    valid = keys[None, None, :] <= rows[:, :, None]               # [B, C, S]
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgcs,bskh->bckgh", p, v.float())
    return out.to(q.dtype)


def _check(q, k_pool, v_pool, page_table, pos, n_new) -> None:
    """Raise ``ValueError`` on anything the kernel does not take: layout
    and types first, then the device."""
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "page_table": page_table, "pos": pos, "n_new": n_new}
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"q dtype {q.dtype} not supported (f32, bf16)")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"pool dtypes {k_pool.dtype}/{v_pool.dtype} must "
                         f"match q's {q.dtype}")
    for name in ("page_table", "pos", "n_new"):
        if tensors[name].dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {tensors[name].dtype}")
    if q.dim() != 5:
        raise ValueError(f"q must be [B, C, KV, G, hd], got {tuple(q.shape)}")
    b, c, kv, g, hd = q.shape
    if k_pool.dim() != 4 or tuple(k_pool.shape[2:]) != (kv, hd):
        raise ValueError(f"pool {tuple(k_pool.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if v_pool.shape != k_pool.shape:
        raise ValueError(f"v_pool {tuple(v_pool.shape)} != k_pool "
                         f"{tuple(k_pool.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"page_table must be [{b}, n_pages], "
                         f"got {tuple(page_table.shape)}")
    if tuple(pos.shape) != (b,) or tuple(n_new.shape) != (b,):
        raise ValueError(f"pos/n_new must be [{b}]")
    if not 1 <= hd <= 256:
        raise ValueError(f"head_dim {hd} outside the kernel's 1..256")
    if not 1 <= k_pool.shape[1] <= 64:
        raise ValueError(f"block_size {k_pool.shape[1]} outside the "
                         f"kernel's 1..64")
    if min(b, c, kv, g, page_table.shape[1]) < 1:
        raise ValueError(f"empty geometry q={tuple(q.shape)} "
                         f"page_table={tuple(page_table.shape)}")
    if c * g > 4 * 65535:
        raise ValueError(f"{c * g} query rows a kv head: the kernel takes at "
                         f"most {4 * 65535}")
    if (paged_design(q.dtype, c, g, hd) == "mma"
            and (q.data_ptr() | k_pool.data_ptr() | v_pool.data_ptr()) % 16):
        raise ValueError("q, k_pool and v_pool must start on a 16-byte "
                         "boundary for the tensor-core design")
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on a CUDA device (with q), "
                             f"got {t.device}")


@functools.cache
def _launcher():
    """The kernel's C entry point, built on first use, its types set once
    (the serving tick calls it once a layer)."""
    from repro_torch.kernels.build import load

    fn = load("paged_attention").paged_attention_launch
    # pointers and the stream as c_void_p: a bare int would be cut to 32 bits
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def paged_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, page_table: torch.Tensor,
                         pos: torch.Tensor, n_new: torch.Tensor, *,
                         all_rows: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (building it on first
    use): the live rows of each lane, zeros past them, or with
    ``all_rows`` every row.  Raises on any argument the kernel does not
    take and on a launch the CUDA runtime refuses; never falls back."""
    _check(q, k_pool, v_pool, page_table, pos, n_new)
    b, c, kv, g, hd = q.shape
    bs, n_pages = k_pool.shape[1], page_table.shape[1]
    fn = _launcher()
    out = torch.empty_like(q)
    n_ws = paged_workspace_elements(b, c, kv, g, hd, bs, n_pages, q.dtype)
    ws = (torch.empty(n_ws, dtype=torch.float32, device=q.device) if n_ws
          else None)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                page_table.data_ptr(), pos.data_ptr(), n_new.data_ptr(),
                out.data_ptr(), None if ws is None else ws.data_ptr(), b, c,
                kv, g, hd, bs, n_pages, hd ** -0.5, _DTYPE_CODES[q.dtype],
                int(all_rows), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {rc} (q {tuple(q.shape)} {q.dtype}, "
                           f"pool {tuple(k_pool.shape)})")
    return out
