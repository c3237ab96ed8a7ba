"""Architecture/config registry: ``--arch <id>`` resolution.

The port's copy of ``repro.core.registry``, over the port's copies of the
configs."""
from __future__ import annotations

from repro_torch.configs import ALL_ARCHS, SHAPES, applicable_shapes
from repro_torch.configs.base import ModelConfig, ShapeConfig, reduced


def resolve_arch(name: str) -> ModelConfig:
    if name in ALL_ARCHS:
        return ALL_ARCHS[name]
    # tolerate module-style ids (dots/dashes vs underscores)
    norm = name.replace("_", "-")
    for k in ALL_ARCHS:
        if k.replace(".", "-") == norm or k == norm:
            return ALL_ARCHS[k]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ALL_ARCHS)}")


def resolve_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def all_cells() -> list[tuple[str, str]]:
    """Every assignment cell (arch, shape), skips included as per DESIGN §6."""
    cells = []
    for arch in ALL_ARCHS:
        for shape in applicable_shapes(arch):
            cells.append((arch, shape))
    return cells


def smoke_config(name: str) -> ModelConfig:
    return reduced(resolve_arch(name))
