"""llama-3.2-vision-90b — VLM: cross-attn image layers every 5th layer.
Vision frontend is a STUB: input_specs() supplies precomputed patch
embeddings (B, 1601, d_model).  [hf:meta-llama/Llama-3.2-90B-Vision]"""
from ..models.config import EncoderConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm",
        n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=28672, vocab=128256, rope_theta=500_000.0,
        cross_attn_period=5,
        encoder=EncoderConfig(n_layers=0, n_ctx=1601),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="vision-smoke", family="vlm",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, cross_attn_period=5, max_seq=128,
        encoder=EncoderConfig(n_layers=0, n_ctx=17),
    )
