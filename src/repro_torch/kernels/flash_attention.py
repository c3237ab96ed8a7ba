"""Blockwise flash attention (the training forward): the CUDA kernel's
wrapper, its plain PyTorch version and the autograd function around it.

Port of ``repro.kernels.flash_attention``.  The TPU kernel
(``flash_attention_pallas``, body ``_flash_kernel``) becomes the hand-written
CUDA kernel in ``csrc/flash_attention.cu`` (its header says how it is laid
out and what bounds it).  ``flash_attention_cuda`` checks the arguments and
launches it on the current stream; it returns the output and the fp32 row
log-sum-exp.  ``flash_attention_plain`` mirrors the reference's
``ref.flash_attention_ref``: fp32 scores, fp32 softmax, P kept in fp32, the
output rounded once to q's dtype.

The kernel has two designs, picked by the arguments before the launch
(``flash_design``): bf16 with D a multiple of 16 from 32, every arch's
head dim, runs on the tensor cores (``"mma"``); f32 and other head dims
run as fp32 FMAs on the CUDA cores (``"scalar"``).  Nothing is retried on
the other design.

The TPU kernel has no backward: the reference trains through its jnp
attention, whose gradient XLA derives.  ``FlashAttention`` (the
``torch.autograd.Function`` the model calls on a card) therefore pairs the
CUDA forward with ``flash_attention_backward``, that same gradient written
in torch ops: P rebuilt from q, k and the saved log-sum-exp, then dV, dP,
dS and dQ, dK, in fp32, q-chunked so the score block stays bounded.
``kernels.ops.flash_attention`` picks the plain version or the kernel by
the tensors' device.

Shapes: q, k, v ``[BH, S, D]`` (kv already broadcast to the q heads),
bf16 or f32, D a multiple of 4 up to 128.  Output ``[BH, S, D]`` in q's
dtype; log-sum-exp ``[BH, S]`` fp32 over the scaled scores.
"""
from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """fp32 scaled scores ``[BH, S, S]``, masked as the reference masks."""
    s = q.shape[1]
    logits = torch.einsum("bqd,bkd->bqk", q.float(),
                          k.float()) * (q.shape[-1] ** -0.5)
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    return logits


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """Plain PyTorch version: dense fp32 softmax attention, one cast."""
    p = torch.softmax(_scores(q, k, causal), dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def logsumexp_plain(q: torch.Tensor, k: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Plain version of the kernel's second output: the fp32 row
    log-sum-exp of the scaled, masked scores ``[BH, S]``."""
    return torch.logsumexp(_scores(q, k, causal), dim=-1)


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, lse: torch.Tensor,
                             d_out: torch.Tensor, *, causal: bool = True,
                             chunk: int = 1024
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Gradients of softmax attention from the forward's log-sum-exp, in
    fp32 torch ops: per chunk of ``chunk`` query rows,
    P = exp(q k^T * scale - lse), dV += P^T dO, dP = dO V^T,
    D = rowsum(P * dP), dS = P * (dP - D), dQ = dS K * scale,
    dK += dS^T Q * scale.  D equals rowsum(dO * O); taken from the fp32 P,
    as XLA's softmax gradient takes it, it does not inherit the rounding of
    an output stored in bf16.  A causal chunk reads only the keys up to its
    last row.  Returns (dq, dk, dv) in the inputs' dtypes."""
    bh, s, d = q.shape
    scale = d ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), d_out.float()
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for i0 in range(0, s, chunk):
        i1 = min(i0 + chunk, s)
        n_k = i1 if causal else s
        qc, doc = qf[:, i0:i1], dof[:, i0:i1]
        kc, vc = kf[:, :n_k], vf[:, :n_k]
        sc = torch.bmm(qc, kc.transpose(1, 2)) * scale
        if causal:
            rows = torch.arange(i0, i1, device=q.device)
            keep = torch.arange(n_k, device=q.device)[None, :] <= rows[:, None]
            sc = sc.masked_fill(~keep, float("-inf"))
        p = torch.exp(sc - lse[:, i0:i1, None])
        dv[:, :n_k] += torch.bmm(p.transpose(1, 2), doc)
        dp = torch.bmm(doc, vc.transpose(1, 2))
        dd = (p * dp).sum(dim=-1, keepdim=True)
        ds = p * (dp - dd)
        dq[:, i0:i1] = torch.bmm(ds, kc) * scale
        dk[:, :n_k] += torch.bmm(ds.transpose(1, 2), qc) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_design(dtype: torch.dtype, d: int) -> str:
    """The design the kernel takes for q's dtype and head dim: ``"mma"``
    (tensor cores: bf16, D a multiple of 16 from 32) or ``"scalar"``.
    Mirrors ``flash_attention_design`` in ``csrc/flash_attention.cu``."""
    mma = dtype == torch.bfloat16 and d % 16 == 0 and d >= 32
    return "mma" if mma else "scalar"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ``ValueError`` on anything the kernel does not take: layout
    and types first, then the device."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"q dtype {q.dtype} not supported (f32, bf16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"k/v dtypes {k.dtype}/{v.dtype} must match q's "
                         f"{q.dtype}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be one [BH, S, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, s, d = q.shape
    if min(bh, s) < 1:
        raise ValueError(f"empty geometry {tuple(q.shape)}")
    if d % 4 or not 4 <= d <= 128:
        raise ValueError(f"head_dim {d} outside the kernel's multiples of 4 "
                         f"in 4..128")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on a CUDA device (with q), "
                             f"got {t.device}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream (building it on first
    use): returns ``(out, lse)``.  Raises on any argument the kernel does
    not take and on a launch the CUDA runtime refuses; never falls back."""
    from repro_torch.kernels.build import load

    _check(q, k, v)
    bh, s, d = q.shape
    fn = load("flash_attention").flash_attention_launch
    # pointers and the stream as c_void_p: a bare int would be cut to 32 bits
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), bh, s, d, d ** -0.5, int(causal),
                _DTYPE_CODES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {rc} (q {tuple(q.shape)} {q.dtype})")
    return out, lse


class FlashAttention(torch.autograd.Function):
    """The CUDA forward with the torch-op backward: what the model runs on
    a card.  Saves q, k, v and the log-sum-exp."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool) -> torch.Tensor:
        out, lse = flash_attention_cuda(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, d_out: torch.Tensor):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, lse, d_out,
                                              causal=ctx.causal)
        return dq, dk, dv, None
