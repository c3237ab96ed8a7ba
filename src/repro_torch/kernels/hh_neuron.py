"""Fused Hodgkin–Huxley soma update: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``repro.kernels.hh_neuron``.  The TPU kernel (``hh_step_pallas``,
body ``_hh_kernel``) becomes the hand-written CUDA kernel in
``csrc/hh_neuron.cu`` (its header says how it is laid out and what bounds
it); ``hh_step_cuda`` checks the arguments and launches it on the current
stream.  ``hh_step_plain`` is the reference's oracle ``ref.hh_step_ref``,
which delegates to the model's own update, ``neuro.cable.hh_soma_update``.
``kernels.ops.hh_step`` picks between the two by the tensors' device.

All seven inputs (``v0, m, h, n, g_syn, i_axial, i_ext``) are ``[N]``
fp32; the outputs are the updated ``(v, m, h, n)``.  The TPU kernel's
padding of N to whole (8, 128) tiles is not carried over: the CUDA kernel
takes any N.
"""
from __future__ import annotations

import ctypes

import torch


def hh_step_plain(v0: torch.Tensor, m: torch.Tensor, h: torch.Tensor,
                  n: torch.Tensor, g_syn: torch.Tensor,
                  i_axial: torch.Tensor, i_ext: torch.Tensor, *,
                  dt: float) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version: the model's own update, op for op."""
    from repro_torch.neuro.cable import hh_soma_update

    return hh_soma_update(v0, m, h, n, g_syn, i_axial, dt, i_ext)


def _check(tensors: dict[str, torch.Tensor]) -> None:
    """Raise ``ValueError`` on anything the kernel does not take: type,
    shape and layout first, then the device."""
    v0 = tensors["v0"]
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 1 or t.shape != v0.shape:
            raise ValueError(f"{name} must be [N] = {tuple(v0.shape)} like "
                             f"v0, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= v0.numel() <= 2**30:
        raise ValueError(f"{v0.numel()} cells: the kernel takes 1 .. 2^30")
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != v0.device:
            raise ValueError(f"{name} must be on a CUDA device (with v0), "
                             f"got {t.device}")


def hh_step_cuda(v0: torch.Tensor, m: torch.Tensor, h: torch.Tensor,
                 n: torch.Tensor, g_syn: torch.Tensor, i_axial: torch.Tensor,
                 i_ext: torch.Tensor, *, dt: float
                 ) -> tuple[torch.Tensor, ...]:
    """Launch the CUDA kernel on the current stream (building it on first
    use).  Raises on any argument the kernel does not take and on a launch
    the CUDA runtime refuses; never falls back."""
    from repro_torch.kernels.build import load

    _check({"v0": v0, "m": m, "h": h, "n": n, "g_syn": g_syn,
            "i_axial": i_axial, "i_ext": i_ext})
    fn = load("hh_neuron").hh_step_launch
    # pointers and the stream as c_void_p: a bare int would be cut to 32 bits
    fn.argtypes = ([ctypes.c_void_p] * 11
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    outs = [torch.empty_like(v0) for _ in range(4)]
    with torch.cuda.device(v0.device):
        # max_blocks 0: one thread per cell (only the CPU emulation cuts
        # the grid, to walk the kernel's grid-stride loop)
        rc = fn(*(t.data_ptr() for t in (v0, m, h, n, g_syn, i_axial, i_ext,
                                         *outs)),
                v0.numel(), dt, 0,
                torch.cuda.current_stream(v0.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hh_step kernel launch failed: cudaError {rc} "
                           f"({v0.numel()} cells)")
    return tuple(outs)
