from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.configs.shapes import (
    SHAPES,
    SUBQUADRATIC_ARCHS,
    ShapeSpec,
    cells_for,
)

__all__ = [
    "MLAConfig",
    "ModelConfig",
    "MoEConfig",
    "ARCH_IDS",
    "get_config",
    "SHAPES",
    "SUBQUADRATIC_ARCHS",
    "ShapeSpec",
    "cells_for",
]
