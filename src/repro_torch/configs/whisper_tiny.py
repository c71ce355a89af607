"""whisper-tiny — enc-dec; conv frontend STUB (precomputed frame
embeddings (B, 1500, 384) via input_specs()).  [arXiv:2212.04356]"""
from ..models.config import EncoderConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", family="audio",
        n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
        d_ff=1536, vocab=51865,
        encoder=EncoderConfig(n_layers=4, n_ctx=1500),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, max_seq=128,
        encoder=EncoderConfig(n_layers=2, n_ctx=32),
    )
