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

from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain)

LAUNCHES: dict[str, int] = {"paged_attention": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_table: torch.Tensor,
                    pos: torch.Tensor, n_new: torch.Tensor) -> torch.Tensor:
    """Chunked decode attention through the page table (the paged serving
    engine's hot path); see ``kernels.paged_attention`` for the shapes."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, page_table, pos,
                                     n_new)
    if q.device.type == "cuda":
        out = paged_attention_cuda(q, k_pool, v_pool, page_table, pos, n_new)
        LAUNCHES["paged_attention"] += 1
        return out
    raise ValueError(f"paged_attention has no kernel for device {q.device}")
