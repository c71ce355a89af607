"""Model zoo of the port: every family's slot path (dense, MoE with MLA,
hybrid Jamba, xLSTM, the VLM and Whisper with their encoder input), and the
dense family's paged path."""

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
    encode,
    forward,
    init_cache,
    init_params,
    layer_kind,
    lm_loss,
    prefill,
    superblock_len,
)

__all__ = [
    "SHAPES", "EncoderConfig", "MLAConfig", "MambaConfig", "MoEConfig",
    "ModelConfig", "ShapeConfig", "XLSTMConfig", "shape_applicable",
    "decode_step", "encode", "forward", "init_cache", "init_params", "layer_kind",
    "lm_loss", "prefill", "superblock_len",
]
