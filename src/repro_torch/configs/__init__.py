from repro_torch.configs.archs import ALL_ARCHS, resolve_arch
from repro_torch.configs.base import ModelConfig, reduced

__all__ = ["ALL_ARCHS", "ModelConfig", "reduced", "resolve_arch"]
