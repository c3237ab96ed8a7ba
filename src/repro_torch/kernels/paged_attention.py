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

Shapes (the reference's layout):
  q          [B, C, KV, G, hd]  post-RoPE queries, bf16 or f32
  k/v_pool   [num_blocks, block_size, KV, hd]  one layer of the page pool,
             already holding this call's fresh rows
  page_table [B, n_pages] int32  physical page per logical block; entries
             past a lane's allocation hold a valid index (0), masked
  pos, n_new [B] int32  rows already cached / fresh rows this call
Output [B, C, KV, G, hd].  Rows ``>= n_new`` of a lane are garbage the
caller discards (the kernel writes them as zeros, the plain version as
whatever its softmax gives; both finite).
"""
from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, page_table: torch.Tensor,
                          pos: torch.Tensor, n_new: torch.Tensor
                          ) -> torch.Tensor:
    """Plain PyTorch version: gather every table page, mask, full fp32
    softmax, P·V in fp32, one cast.  Mathematically the kernel's function
    on every valid row."""
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
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on a CUDA device (with q), "
                             f"got {t.device}")


def paged_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, page_table: torch.Tensor,
                         pos: torch.Tensor, n_new: torch.Tensor
                         ) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (building it on first
    use).  Raises on any argument the kernel does not take and on a launch
    the CUDA runtime refuses; never falls back."""
    from repro_torch.kernels.build import load

    _check(q, k_pool, v_pool, page_table, pos, n_new)
    b, c, kv, g, hd = q.shape
    lib = load("paged_attention")
    fn = lib.paged_attention_launch
    # pointers and the stream as c_void_p: a bare int would be cut to 32 bits
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                page_table.data_ptr(), pos.data_ptr(), n_new.data_ptr(),
                out.data_ptr(), b, c, kv, g, hd, k_pool.shape[1],
                page_table.shape[1], hd ** -0.5, _DTYPE_CODES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {rc} (q {tuple(q.shape)} {q.dtype}, "
                           f"pool {tuple(k_pool.shape)})")
    return out
