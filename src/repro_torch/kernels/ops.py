"""Kernel entry points the model calls, dispatched by the tensors' device.

A CPU tensor takes the kernel's plain PyTorch version; a CUDA tensor
launches the hand-written kernel or raises.  There is no switch to force
either side and no fallback on failure: where a tensor lives decides.

``LAUNCHES`` counts the kernel launches made through these entry points,
one per launch, so a run can show that its path really went through the
kernels (``reset_launches`` before the run, read after).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention_plain)
from repro_torch.kernels.hh_neuron import (cable_epoch_cuda,
                                           cable_epoch_plain, hh_step_cuda,
                                           hh_step_plain)
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain)
from repro_torch.kernels.ssd_scan import SsdScan, ssd_scan_plain

LAUNCHES: dict[str, int] = {"paged_attention": 0, "flash_attention": 0,
                            "ssd_scan": 0, "hh_step": 0, "cable_epoch": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_table: torch.Tensor,
                    pos: torch.Tensor, n_new: torch.Tensor, *,
                    all_rows: bool = False) -> torch.Tensor:
    """Chunked decode attention through the page table (the paged serving
    engine's hot path); see ``kernels.paged_attention`` for the shapes.
    ``all_rows`` asks for every row of a lane's chunk, as the plain version
    computes it (the moe family's); without it the kernel computes only
    the live rows and writes the others as zeros."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, page_table, pos,
                                     n_new)
    if q.device.type == "cuda":
        out = paged_attention_cuda(q, k_pool, v_pool, page_table, pos, n_new,
                                   all_rows=all_rows)
        LAUNCHES["paged_attention"] += 1
        return out
    raise ValueError(f"paged_attention has no kernel for device {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Blockwise attention over ``[BH, S, D]`` (the training forward); see
    ``kernels.flash_attention`` for the shapes.  On a card the kernel runs
    inside ``FlashAttention``, whose backward is written in torch ops."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type == "cuda":
        out = FlashAttention.apply(q, k, v, causal)
        LAUNCHES["flash_attention"] += 1
        return out
    raise ValueError(f"flash_attention has no kernel for device {q.device}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_in: torch.Tensor, c_in: torch.Tensor, chunk: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba2's chunked SSD scan -> ``(y, final_state)``; see
    ``kernels.ssd_scan`` for the shapes.  The chunk is cut to the sequence
    (``min(chunk, S)``) and must divide it, as the reference asserts.  On a
    card the kernel runs inside ``SsdScan``, whose backward is written in
    torch ops."""
    s = x.shape[1]
    chunk = min(chunk, s)
    if chunk < 1 or s % chunk:
        raise ValueError(f"ssd_scan: sequence {s} is not a multiple of the "
                         f"chunk {chunk}")
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, b_in, c_in, chunk)
    if x.device.type == "cuda":
        out = SsdScan.apply(x, dt, a, b_in, c_in, chunk)
        LAUNCHES["ssd_scan"] += 1
        return out
    raise ValueError(f"ssd_scan has no kernel for device {x.device}")


def hh_step(v0: torch.Tensor, m: torch.Tensor, h: torch.Tensor,
            n: torch.Tensor, g_syn: torch.Tensor, i_axial: torch.Tensor,
            dt: float, i_ext: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The fused HH soma update -> ``(v, m, h, n)``, all ``[N]`` fp32; the
    signature of ``neuro.cable.hh_soma_update``, as in the reference."""
    if v0.device.type == "cpu":
        return hh_step_plain(v0, m, h, n, g_syn, i_axial, i_ext, dt=dt)
    if v0.device.type == "cuda":
        out = hh_step_cuda(v0, m, h, n, g_syn, i_axial, i_ext, dt=dt)
        LAUNCHES["hh_step"] += 1
        return out
    raise ValueError(f"hh_step has no kernel for device {v0.device}")


def cable_epoch(state, cfg, incoming: torch.Tensor, i_stim: torch.Tensor,
                stim_left: int):
    """One exchange epoch of cable steps -> ``(new state, spiked [steps, N]
    bool)``: ``state`` a ``neuro.cable.CellState``, ``cfg`` its
    ``CellConfig``, ``incoming`` the spikes arriving at each step ``[steps,
    N]`` fp32; step ``s`` takes ``i_stim`` ``[N]`` while ``s < stim_left``.
    See ``kernels.hh_neuron``."""
    if state.v.device.type == "cpu":
        return cable_epoch_plain(state, cfg, incoming, i_stim, stim_left)
    if state.v.device.type == "cuda":
        out = cable_epoch_cuda(state, cfg, incoming, i_stim, stim_left)
        LAUNCHES["cable_epoch"] += 1
        return out
    raise ValueError(f"cable_epoch has no kernel for device "
                     f"{state.v.device}")
