from repro_torch.configs.archs import (ALL_ARCHS, SUBQUADRATIC,
                                       applicable_shapes)
from repro_torch.configs.base import (MULTI_POD, SHAPES, SINGLE_POD,
                                      TINY_MESH, MeshConfig, ModelConfig,
                                      RunConfig, ShapeConfig, TrainConfig,
                                      reduced)

__all__ = [
    "SHAPES", "SINGLE_POD", "MULTI_POD", "TINY_MESH",
    "MeshConfig", "ModelConfig", "RunConfig", "ShapeConfig", "TrainConfig",
    "reduced", "ALL_ARCHS", "SUBQUADRATIC", "applicable_shapes",
]
