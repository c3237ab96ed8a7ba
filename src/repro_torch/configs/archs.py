"""The ten assigned architectures: the port's own copy of
``repro.configs.archs`` (``[source; tier]`` recorded in ``source``)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

LLAMA32_VISION_11B = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256, cross_every=5, n_image_tokens=1600,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)

MAMBA2_2P7B = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    ssm_groups=1, conv_width=4, ssd_chunk=256,
    source="arXiv:2405.21060; unverified",
)

PHI3_MINI_3P8B = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab_size=32064, rope_theta=10_000.0,
    source="arXiv:2404.14219; unverified",
)

PHI3_MEDIUM_14B = ModelConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, head_dim=128,
    d_ff=17920, vocab_size=100352, rope_theta=10_000.0,
    source="arXiv:2404.14219; unverified",
)

DEEPSEEK_7B = ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=11008, vocab_size=102400, rope_theta=10_000.0,
    source="arXiv:2401.02954; hf",
)

DEEPSEEK_CODER_33B = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=19200, vocab_size=32256, rope_theta=100_000.0,
    source="arXiv:2401.14196; hf",
)

QWEN3_MOE_30B_A3B = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151936, n_experts=128, top_k=8, qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)

GRANITE_MOE_1B_A400M = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155, n_experts=32, top_k=8,
    rope_theta=10_000.0, tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)

WHISPER_MEDIUM = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=51865, n_encoder_layers=24,
    n_audio_frames=1500, decoder_train_len=448, rope_theta=0.0,
    source="arXiv:2212.04356; unverified",
)

ZAMBA2_2P7B = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000, ssm_state=64, ssm_head_dim=64,
    ssm_expand=2, ssm_groups=1, conv_width=4, ssd_chunk=256, attn_every=6,
    source="arXiv:2411.15242; hf",
)

ALL_ARCHS: dict[str, ModelConfig] = {
    m.name: m
    for m in (
        LLAMA32_VISION_11B, MAMBA2_2P7B, PHI3_MINI_3P8B, PHI3_MEDIUM_14B,
        DEEPSEEK_7B, DEEPSEEK_CODER_33B, QWEN3_MOE_30B_A3B,
        GRANITE_MOE_1B_A400M, WHISPER_MEDIUM, ZAMBA2_2P7B,
    )
}


def resolve_arch(name: str) -> ModelConfig:
    """``--arch <id>`` resolution (mirrors ``repro.core.registry``)."""
    if name in ALL_ARCHS:
        return ALL_ARCHS[name]
    # tolerate module-style ids (dots/dashes vs underscores)
    norm = name.replace("_", "-")
    for k in ALL_ARCHS:
        if k.replace(".", "-") == norm or k == norm:
            return ALL_ARCHS[k]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ALL_ARCHS)}")
