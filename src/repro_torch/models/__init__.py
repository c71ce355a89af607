"""Model zoo of the port: the dense family's paged serving path so far."""

from .config import (
    SHAPES,
    EncoderConfig,
    MLAConfig,
    MambaConfig,
    MoEConfig,
    ModelConfig,
    ShapeConfig,
    XLSTMConfig,
    shape_applicable,
)
from .transformer import init_params, layer_kind, superblock_len

__all__ = [
    "SHAPES", "EncoderConfig", "MLAConfig", "MambaConfig", "MoEConfig",
    "ModelConfig", "ShapeConfig", "XLSTMConfig", "shape_applicable",
    "init_params", "layer_kind", "superblock_len",
]
