from repro_torch.configs.archs import ALL_ARCHS, resolve_arch
from repro_torch.configs.base import (ModelConfig, RunConfig, ShapeConfig,
                                      TrainConfig, reduced)

__all__ = ["ALL_ARCHS", "ModelConfig", "RunConfig", "ShapeConfig",
           "TrainConfig", "reduced", "resolve_arch"]
