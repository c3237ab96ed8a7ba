"""int8 gradient compression with a per-tensor scale.

Port of ``repro.optim.compress``: each gradient makes the int8 round trip
(quantise with scale ``max|g| / 127``, round half to even, clip to ±127,
dequantise to fp32) where a data-parallel run would all-reduce the int8
tensor.  The quantisation error is re-seen through the loss on the next
step (the reference's error feedback).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.params import tree_map


def _q(g: torch.Tensor) -> torch.Tensor:
    g32 = g.float()
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q.float() * scale


def compress_decompress(grads: Any) -> Any:
    return tree_map(_q, grads)
