"""Mamba2 SSD chunked scan: the CUDA kernel's wrapper, its plain PyTorch
version, its gradient and the autograd function around them.

Port of ``repro.kernels.ssd_scan``.  The TPU kernel (``ssd_scan_pallas``,
body ``_ssd_kernel``) becomes the hand-written CUDA kernel in
``csrc/ssd_scan.cu`` (its header says how it is laid out and what bounds
it).  ``ssd_scan_cuda`` checks the arguments and launches it on the current
stream.  ``ssd_scan_plain`` is the reference's oracle ``ref.ssd_scan_ref``,
that is ``models.ssm.ssd_chunked``, in torch ops, ``init_state`` kept.

The kernel has two designs, picked by the arguments before the launch
(``ssd_design``): bf16 with P and N multiples of 16 and a chunk that is a
multiple of 64 up to 256, every arch's call, runs chunk-parallel on the
tensor cores (``"mma"``: four passes sharing an fp32 workspace of
``ssd_workspace_elements`` floats, which the wrapper allocates; y rounds
as the plain version's does, see the kernel's header); f32 and other
shapes run as fp32 FMAs, one block per (batch, head) (``"scalar"``).
Nothing is retried on the other design.

The TPU kernel has no backward: the reference trains through its jnp
``ssd_chunked``, whose gradient XLA derives.  ``SsdScan`` (the
``torch.autograd.Function`` the model calls on a card) therefore pairs the
CUDA forward with ``ssd_scan_backward``: the same chunked algorithm
recomputed in fp32 and differentiated by ``torch.autograd``.  It is a
function of its own, apart from the plain version, and takes the decay
``exp(seg_q - seg_k)`` only where ``k <= q``: the plain version's dense
exp overflows above the diagonal once a chunk's summed ``dt * a`` passes
about 88, and its gradient would carry ``0 * inf`` back.
``kernels.ops.ssd_scan`` picks the plain version or the kernel by the
tensors' device.

Shapes: x ``[B, S, H, P]`` bf16 or f32; dt ``[B, S, H]`` fp32 (after
softplus); a ``[H]`` fp32 (negative); b_in, c_in ``[B, S, G, N]`` in x's
dtype, groups broadcast to heads by ``h // (H // G)``.  Returns y
``[B, S, H, P]`` in x's dtype and the final state ``[B, H, P, N]`` fp32.
"""
from __future__ import annotations

import ctypes

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_P = MAX_N = 128


def ssd_design(dtype: torch.dtype, p: int, n: int, chunk: int) -> str:
    """The design the kernel takes for x's dtype, P, N and the chunk:
    ``"mma"`` (chunk-parallel on the tensor cores: bf16, P and N multiples
    of 16, a chunk that is a multiple of 64 up to 256) or ``"scalar"``.
    Mirrors ``ssd_scan_design`` in ``csrc/ssd_scan.cu``."""
    mma = (dtype == torch.bfloat16 and p % 16 == 0 and n % 16 == 0
           and chunk % 64 == 0 and chunk <= 256)
    return "mma" if mma else "scalar"


STATE_PARTS = 3   # bf16 parts of an incoming state (``kParts``)


def ssd_workspace_elements(b: int, s: int, h: int, p: int, n: int,
                           chunk: int, g: int) -> int:
    """fp32 elements of the chunk-parallel design's workspace: every
    chunk's own state ``[B, S / chunk, H, P, N]`` fp32, its incoming state
    as ``STATE_PARTS`` bf16 parts, seg ``[B, S / chunk, H, chunk]``,
    C·Bᵀ ``[B, S / chunk, G, chunk, chunk]`` fp32, and the values handed
    to the last pass: a count for every 16 query rows of a head and
    ``2 P`` entries each.  Equals ``ssd_scan_workspace_floats`` in
    ``csrc/ssd_scan.cu``."""
    states = b * (s // chunk) * h * p * n
    tokens = b * s
    return (states + (STATE_PARTS * states + 1) // 2 + tokens * h
            + tokens * g * chunk + tokens * h // 16
            + tokens * h // 16 * (2 * p))


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b_in: torch.Tensor, c_in: torch.Tensor, chunk: int,
                   init_state: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the reference's chunked SSD, op for op, fp32
    inside and y rounded once to x's dtype."""
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    nc = s // chunk
    if nc * chunk != s:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    hg = h // g
    f32 = torch.float32
    dtc = dt.reshape(bsz, nc, chunk, h).to(f32)
    seg = torch.cumsum(dtc * a, dim=2)                        # [B,c,Q,H]
    xc = x.reshape(bsz, nc, chunk, h, p).to(f32)
    bc = b_in.reshape(bsz, nc, chunk, g, n).to(f32)
    cc = c_in.reshape(bsz, nc, chunk, g, n).to(f32)

    # intra-chunk (quadratic, masked)
    cb = torch.einsum("bcqgn,bckgn->bcgqk", cc, bc)
    cb = cb.repeat_interleave(hg, dim=2)                      # [B,c,H,Q,K]
    seg_t = seg.transpose(2, 3)                               # [B,c,H,Q]
    decay = torch.exp(seg_t[..., :, None] - seg_t[..., None, :])
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    m = torch.where(mask, cb * decay, torch.zeros((), dtype=f32,
                                                  device=x.device))
    m = m * dtc.transpose(2, 3)[..., None, :]
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", m, xc)

    # chunk states
    last = seg[:, :, -1:, :]                                  # [B,c,1,H]
    w_k = torch.exp(last - seg) * dtc
    bh_ = bc.repeat_interleave(hg, dim=3)                     # [B,c,K,H,N]
    states = torch.einsum("bckhn,bckh,bckhp->bchpn", bh_, w_k, xc)

    # inter-chunk recurrence
    chunk_decay = torch.exp(last[:, :, 0, :])                 # [B,c,H]
    carry = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(carry)    # the *incoming* state of chunk c
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                    # [B,c,H,P,N]

    ch = cc.repeat_interleave(hg, dim=3)                      # [B,c,Q,H,N]
    y_inter = torch.einsum("bcqhn,bcqh,bchpn->bcqhp", ch, torch.exp(seg),
                           prev_states)
    y = (y_intra + y_inter).reshape(bsz, s, h, p).to(x.dtype)
    return y, carry


def _ssd_fp32(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              b_in: torch.Tensor, c_in: torch.Tensor, chunk: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD on fp32 inputs, written to be differentiated: the
    decay is exp of a difference masked to ``-inf`` above the diagonal
    (so it and its gradient are 0 there, never inf), and heads stay split
    as ``(G, H/G)`` so C·Bᵀ is not repeated per head."""
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    nc, hg = s // chunk, h // g
    dtc = dt.reshape(bsz, nc, chunk, g, hg)
    seg = torch.cumsum(dtc * a.reshape(g, hg), dim=2)         # [B,c,Q,G,E]
    xc = x.reshape(bsz, nc, chunk, g, hg, p)
    bc = b_in.reshape(bsz, nc, chunk, g, n)
    cc = c_in.reshape(bsz, nc, chunk, g, n)

    cb = torch.einsum("bcqgn,bckgn->bcgqk", cc, bc)           # [B,c,G,Q,K]
    seg_t = seg.permute(0, 1, 3, 4, 2)                        # [B,c,G,E,Q]
    diff = seg_t[..., :, None] - seg_t[..., None, :]          # [B,c,G,E,Q,K]
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(diff.masked_fill(~mask, float("-inf")))
    m = cb[:, :, :, None] * decay * dtc.permute(0, 1, 3, 4, 2)[..., None, :]
    y_intra = torch.einsum("bcgeqk,bckgep->bcqgep", m, xc)

    last = seg[:, :, -1:]                                     # [B,c,1,G,E]
    w_k = torch.exp(last - seg) * dtc                         # [B,c,K,G,E]
    states = torch.einsum("bckgn,bckge,bckgep->bcgepn", bc, w_k, xc)
    chunk_decay = torch.exp(last[:, :, 0])                    # [B,c,G,E]
    carry = torch.zeros((bsz, g, hg, p, n), dtype=x.dtype, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                    # [B,c,G,E,P,N]
    y_inter = torch.einsum("bcqgn,bcqge,bcgepn->bcqgep", cc, torch.exp(seg),
                           prev_states)
    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    return y, carry.reshape(bsz, h, p, n)


def ssd_scan_backward(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      b_in: torch.Tensor, c_in: torch.Tensor, chunk: int,
                      d_y: torch.Tensor | None,
                      d_final: torch.Tensor | None
                      ) -> tuple[torch.Tensor, ...]:
    """Gradients of the scan with respect to x, dt, a, b_in and c_in, in
    their dtypes, from the cotangents of y and of the final state (either
    may be ``None``).  The forward is recomputed in fp32 torch ops
    (``_ssd_fp32``) and differentiated by autograd, as XLA differentiates
    the reference's ``ssd_chunked``."""
    inputs = (x, dt, a, b_in, c_in)
    with torch.enable_grad():
        leaves = [t.detach().to(torch.float32).requires_grad_()
                  for t in inputs]
        y, final = _ssd_fp32(*leaves, chunk)
        outs = [o for o, d in ((y, d_y), (final, d_final)) if d is not None]
        cots = [d.to(torch.float32) for d in (d_y, d_final) if d is not None]
        grads = torch.autograd.grad(outs, leaves, cots)
    return tuple(gr.to(t.dtype) for gr, t in zip(grads, inputs))


def _check(x, dt, a, b_in, c_in, chunk) -> None:
    """Raise ``ValueError`` on anything the kernel does not take: layout
    and types first, then the device."""
    named = (("x", x), ("dt", dt), ("a", a), ("b_in", b_in), ("c_in", c_in))
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x dtype {x.dtype} not supported (f32, bf16)")
    if b_in.dtype != x.dtype or c_in.dtype != x.dtype:
        raise ValueError(f"b_in/c_in dtypes {b_in.dtype}/{c_in.dtype} must "
                         f"match x's {x.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"dt and a must be float32, got {dt.dtype}, "
                         f"{a.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be [B, S, H, P], got {tuple(x.shape)}")
    bsz, s, h, p = x.shape
    if b_in.dim() != 4 or c_in.shape != b_in.shape or (
            b_in.shape[:2] != (bsz, s)):
        raise ValueError(f"b_in, c_in must be one [B, S, G, N] shape with "
                         f"x's B, S; got {tuple(b_in.shape)}, "
                         f"{tuple(c_in.shape)}")
    g, n = b_in.shape[2], b_in.shape[3]
    if tuple(dt.shape) != (bsz, s, h) or tuple(a.shape) != (h,):
        raise ValueError(f"dt must be [B, S, H] and a [H], got "
                         f"{tuple(dt.shape)}, {tuple(a.shape)}")
    if min(bsz, s, h, p, g, n) < 1 or h % g:
        raise ValueError(f"bad geometry: x {tuple(x.shape)}, groups {g}")
    if p > MAX_P or n > MAX_N:
        raise ValueError(f"head dim {p} / state {n} above the kernel's "
                         f"{MAX_P} / {MAX_N}")
    if not 1 <= chunk <= s or s % chunk:
        raise ValueError(f"chunk {chunk} must divide the sequence {s}")
    if ssd_design(x.dtype, p, n, chunk) == "mma":
        for name, t in (("x", x), ("b_in", b_in), ("c_in", c_in)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
    for name, t in named:
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must be on a CUDA device (with x), "
                             f"got {t.device}")


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b_in: torch.Tensor, c_in: torch.Tensor, chunk: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream (building it on first
    use): returns ``(y, final_state)``.  Raises on any argument the kernel
    does not take and on a launch the CUDA runtime refuses; never falls
    back."""
    from repro_torch.kernels.build import load

    _check(x, dt, a, b_in, c_in, chunk)
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    fn = load("ssd_scan").ssd_scan_launch
    # pointers and the stream as c_void_p: a bare int would be cut to 32 bits
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    y = torch.empty_like(x)
    final = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ws = None
    if ssd_design(x.dtype, p, n, chunk) == "mma":
        ws = torch.empty(ssd_workspace_elements(bsz, s, h, p, n, chunk, g),
                         dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_in.data_ptr(),
                c_in.data_ptr(), y.data_ptr(), final.data_ptr(),
                None if ws is None else ws.data_ptr(), bsz, s, h, p, g, n,
                chunk, _DTYPE_CODES[x.dtype],
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {rc} "
                           f"(x {tuple(x.shape)} {x.dtype}, chunk {chunk})")
    return y, final


class SsdScan(torch.autograd.Function):
    """The CUDA forward with the torch-op backward: what the model runs on
    a card.  Differentiates x, dt, a, b_in and c_in from the cotangents of
    y and the final state; saves the five inputs."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_in: torch.Tensor, c_in: torch.Tensor, chunk: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
        y, final = ssd_scan_cuda(x, dt, a, b_in, c_in, chunk)
        ctx.save_for_backward(x, dt, a, b_in, c_in)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, d_y: torch.Tensor | None,
                 d_final: torch.Tensor | None):
        if d_y is None and d_final is None:
            return (None,) * 6
        # a profiler span, so a trace can attribute the backward's device
        # time to the scan
        with torch.profiler.record_function("ssd_scan_backward"):
            grads = ssd_scan_backward(*ctx.saved_tensors, ctx.chunk, d_y,
                                      d_final)
        return (*grads, None)
