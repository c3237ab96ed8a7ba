"""Layer primitives on tensors: norms, RoPE, SwiGLU, embeddings.

Ports ``repro.models.layers`` at tensor-parallel width 1.  There the
sequence-parallel helpers ``sp_col_projects`` and ``rs_project`` reduce to
``x @ w`` with no shard context bound, so that is all the port keeps.  The
rounding points follow the reference exactly (fp32 statistics in
``rmsnorm``, fp32 angles in ``rope``, one cast back at the end of each),
which is what keeps reduced-size token streams identical across the two
frameworks on the CPU.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig


def ceil_mult(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------- norms


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalise in fp32, cast back to ``x.dtype``, then scale by ``w``."""
    h = x.float()
    var = (h * h).mean(dim=-1, keepdim=True)
    return (h * torch.rsqrt(var + eps)).to(x.dtype) * w


# ---------------------------------------------------------------- rope


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-split.  x: [..., seq, heads, head_dim],
    pos: [..., seq]."""
    if theta <= 0:
        return x
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = pos[..., :, None].float() * freqs        # [..., seq, half]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------- MLP


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with ``sigmoid = 1 / (1 + exp(-x))``, each op
    rounded to ``x.dtype``: the reference's ``jax.nn.silu`` lowers to that
    chain.  ``F.silu`` rounds once and differs in about a third of the bf16
    outputs by one ulp."""
    return x * (1 / (1 + torch.exp(-x)))


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    g = x @ p["gate"]
    u = x @ p["up"]
    return (silu(g) * u) @ p["down"]


# ---------------------------------------------------------------- embed / head


def embed_tokens(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens]


def logits_from(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Logits over the whole padded vocab, in fp32 (as the reference:
    argmax runs over the padded ids too)."""
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    return (x @ w).float()


# ---------------------------------------------------------------- GQA geometry


@dataclasses.dataclass(frozen=True)
class HeadGeom:
    """Padding geometry making GQA shardable over a ``tp``-wide model axis.

    train/prefill compute: kv replicated over tp; q padded on the group dim
      to ``g_pad`` so that ``kv·g_pad % tp == 0``  (H_run = kv·g_pad).
    decode cache: kv zero-padded to ``kv_pad = ceil_mult(kv, tp)`` so the
      cache head dim itself shards     (H_dec = kv_pad·g).

    The port runs at tp=1, where no padding happens; the class is kept
    whole so the geometry reads the same in both packages.
    """

    n_heads: int
    n_kv: int
    head_dim: int
    tp: int

    @property
    def group(self) -> int:
        return self.n_heads // self.n_kv

    @property
    def g_pad(self) -> int:
        g = self.group
        while (self.n_kv * g) % self.tp:
            g += 1
        return g

    @property
    def h_run(self) -> int:
        return self.n_kv * self.g_pad

    @property
    def kv_pad(self) -> int:
        return ceil_mult(self.n_kv, self.tp)

    @property
    def h_dec(self) -> int:
        return self.kv_pad * self.group


def head_geom(cfg: ModelConfig, tp: int = 1) -> HeadGeom:
    return HeadGeom(cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, tp)
