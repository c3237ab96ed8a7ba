"""Model configuration: the port's own copy of ``repro.configs.base``.

Pure data, copied rather than imported so that the port never loads the
JAX package.  Field names, defaults and ``reduced()`` match the reference
exactly; ``tests/test_torch_layers.py`` holds the two copies equal.
``ShapeConfig`` and ``TrainConfig`` are copied whole; ``RunConfig`` keeps the
fields a single-GPU run reads (the mesh and sharding rules wait for the
multi-GPU slice; ``use_pallas`` has no counterpart, since the port picks a
kernel by the tensors' device).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.  One instance per assigned arch.

    ``family`` selects the block layout:
      dense   — decoder-only, attention+MLP blocks
      moe     — decoder-only, attention+MoE blocks
      ssm     — decoder-only, Mamba2 (SSD) blocks, attention-free
      hybrid  — Mamba2 blocks + a globally *shared* attention block every
                ``attn_every`` blocks (zamba2)
      encdec  — encoder-decoder (whisper); frontend stubbed
      vlm     — decoder-only with cross-attention blocks every
                ``cross_every`` layers attending to stubbed patch embeddings

    The port builds the dense, moe, ssm and hybrid families; the other
    families' fields are kept so every assigned arch is described
    identically in both packages.
    """

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0          # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_width: int = 4
    ssd_chunk: int = 256
    # --- hybrid (zamba2) ---
    attn_every: int = 6        # a shared attention block after every N-1 mamba blocks
    # --- vlm ---
    cross_every: int = 5       # one cross-attn block per `cross_every` self layers
    n_image_tokens: int = 1600
    # --- encdec (whisper) ---
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500  # encoder sequence length for non-train shapes
    decoder_train_len: int = 448
    # --- common ---
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    qk_norm: bool = False      # qwen3-style per-head q/k RMSNorm
    dtype: str = "bfloat16"
    # ref: citation string from the assignment table
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Embedding tables padded to a multiple of 256 so the vocab dim is
        always shardable over a 16-wide model axis (Megatron-style)."""
        return _round_up(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count of the families the port builds."""
        from repro_torch.models import params as P  # local: avoid a cycle

        return P.count(P.param_specs(self))

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: ``top_k`` experts only), as
        the reference's ``stack.param_count(active_only=True)``."""
        total = self.param_count()
        if self.n_experts and self.top_k:
            expert = 3 * self.d_model * self.d_ff  # gate + up + down
            total -= self.n_layers * expert * (self.n_experts - self.top_k)
        return total


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""

    name: str       # train_4k | prefill_32k | decode_32k | long_500k
    kind: str       # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    z_loss: float = 1e-4
    seed: int = 0
    # remat: 'none' | 'full' | 'selective' (save only block boundaries)
    remat: str = "full"
    # microbatching (gradient accumulation) — 0 disables
    microbatches: int = 0
    # gradient compression: 'none' | 'int8_ef'
    grad_compress: str = "none"


@dataclass(frozen=True)
class RunConfig:
    """Everything one single-GPU run needs."""

    model: ModelConfig
    shape: ShapeConfig
    train: TrainConfig = field(default_factory=TrainConfig)


def reduced(model: ModelConfig, **overrides: Any) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    small: dict[str, Any] = dict(
        n_layers=min(model.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(model.n_kv_heads, 2),
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        n_experts=min(model.n_experts, 8) if model.n_experts else 0,
        top_k=min(model.top_k, 2) if model.top_k else 0,
        ssm_state=min(model.ssm_state, 16) if model.ssm_state else 0,
        ssm_head_dim=32,
        ssd_chunk=16,
        n_image_tokens=16,
        n_encoder_layers=2 if model.n_encoder_layers else 0,
        n_audio_frames=32,
        decoder_train_len=16,
        attn_every=2,
        cross_every=2,
        name=model.name + "-smoke",
    )
    small.update(overrides)
    return dataclasses.replace(model, **small)
