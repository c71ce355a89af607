"""Model zoo of the port: the dense family's slot and paged serving paths, and
the hybrid (Jamba) family's slot path."""

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
from .transformer import (
    decode_step,
    forward,
    init_cache,
    init_params,
    layer_kind,
    prefill,
    superblock_len,
)

__all__ = [
    "SHAPES", "EncoderConfig", "MLAConfig", "MambaConfig", "MoEConfig",
    "ModelConfig", "ShapeConfig", "XLSTMConfig", "shape_applicable",
    "decode_step", "forward", "init_cache", "init_params", "layer_kind",
    "prefill", "superblock_len",
]
