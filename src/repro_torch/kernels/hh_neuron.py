"""Hodgkin–Huxley cable cells: the CUDA kernels' wrappers and their plain
PyTorch versions.

Port of ``repro.kernels.hh_neuron``.  The TPU kernel (``hh_step_pallas``,
body ``_hh_kernel``) becomes two hand-written CUDA kernels in
``csrc/hh_neuron.cu`` (its header says how they are laid out and what
bounds them), which share one soma function:

* ``hh_step_cuda`` launches one dt step's soma update; its plain version
  ``hh_step_plain`` is the reference's oracle ``ref.hh_step_ref``, which
  delegates to the model's own update, ``neuro.cable.hh_soma_update``.
  All seven inputs (``v0, m, h, n, g_syn, i_axial, i_ext``) are ``[N]``
  fp32; the outputs are the updated ``(v, m, h, n)``.
* ``cable_epoch_cuda`` advances every cell through one whole exchange
  epoch of cable steps in one launch: the reference's inner ``lax.scan``
  of ``neuro.sim._epoch_fn``, with the soma kernel inside.  Its plain
  version ``cable_epoch_plain`` is that loop of ``neuro.cable``'s step
  arithmetic with ``hh_soma_update`` as the soma.

``kernels.ops`` picks between each pair by the tensors' device.  The TPU
kernel's padding of N to whole (8, 128) tiles is not carried over: the
CUDA kernels take any N.
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


# the compartment counts the epoch kernel is instantiated for
EPOCH_COMPARTMENTS = (2, 4, 8, 16, 32, 64)


def cable_epoch_plain(state, cfg, incoming: torch.Tensor,
                      i_stim: torch.Tensor, stim_left: int):
    """Plain PyTorch version of one epoch: ``incoming.shape[0]`` steps of
    ``neuro.cable``'s step arithmetic with ``hh_soma_update`` as the soma,
    so it launches no kernel on any device.  Step ``s`` takes ``i_stim``
    while ``s < stim_left`` and zeros after.  Returns ``(new state,
    spiked [steps, N] bool)``."""
    from repro_torch.neuro.cable import advance, hh_soma_update

    i_rest = torch.zeros_like(i_stim)
    spiked = torch.empty(incoming.shape, dtype=torch.bool,
                         device=incoming.device)
    for s in range(incoming.shape[0]):
        state, spiked[s] = advance(state, cfg, incoming[s],
                                   i_stim if s < stim_left else i_rest,
                                   hh_soma_update)
    return state, spiked


def _check_epoch(state, incoming: torch.Tensor, i_stim: torch.Tensor
                 ) -> None:
    """Raise ``ValueError`` on anything the epoch kernel does not take:
    compartments, type, shape and layout first, then the device."""
    v = state.v
    named = {"v": v, "m": state.m, "h": state.h, "n": state.n,
             "g_syn": state.g_syn, "incoming": incoming, "i_stim": i_stim}
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if v.dim() != 2:
        raise ValueError(f"v must be [N, C], got {tuple(v.shape)}")
    cells, comps = v.shape
    if comps not in EPOCH_COMPARTMENTS:
        raise ValueError(f"{comps} compartments: the epoch kernel takes "
                         f"{EPOCH_COMPARTMENTS}")
    if not 1 <= cells <= 2**30:
        raise ValueError(f"{cells} cells: the kernel takes 1 .. 2^30")
    for name in ("m", "h", "n", "g_syn", "i_stim"):
        if tuple(named[name].shape) != (cells,):
            raise ValueError(f"{name} must be [N] = ({cells},), got "
                             f"{tuple(named[name].shape)}")
    if (incoming.dim() != 2 or incoming.shape[1] != cells
            or not 1 <= incoming.shape[0] < 2**31):
        raise ValueError(f"incoming must be [steps >= 1, N = {cells}], got "
                         f"{tuple(incoming.shape)}")
    for name, t in named.items():
        if t.device.type != "cuda" or t.device != v.device:
            raise ValueError(f"{name} must be on a CUDA device (with v), "
                             f"got {t.device}")


def cable_epoch_cuda(state, cfg, incoming: torch.Tensor,
                     i_stim: torch.Tensor, stim_left: int):
    """Launch the epoch kernel on the current stream (building it on first
    use): the same function as ``cable_epoch_plain``, into new tensors.
    Raises on any argument the kernel does not take and on a launch the
    CUDA runtime refuses; never falls back."""
    from repro_torch.kernels.build import load
    from repro_torch.neuro.cable import C_M, syn_decay

    _check_epoch(state, incoming, i_stim)
    fn = load("hh_neuron").cable_epoch_launch
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 7 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    v = state.v
    cells, comps = v.shape
    outs = [torch.empty_like(t) for t in state]
    spiked = torch.empty(incoming.shape, dtype=torch.bool, device=v.device)
    # stim_left only ever compares with a step index: clamp it to int range
    stim_left = min(max(int(stim_left), 0), incoming.shape[0])
    with torch.cuda.device(v.device):
        rc = fn(*(t.data_ptr() for t in (*state, incoming, i_stim, *outs,
                                         spiked)),
                cells, comps, incoming.shape[0], stim_left, cfg.dt,
                cfg.dt / C_M, cfg.g_axial, cfg.g_pas, cfg.e_pas,
                syn_decay(cfg), cfg.syn_weight, 0,
                torch.cuda.current_stream(v.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cable_epoch kernel launch failed: cudaError "
                           f"{rc} ({cells} cells x {comps} compartments, "
                           f"{incoming.shape[0]} steps)")
    return type(state)(*outs), spiked
