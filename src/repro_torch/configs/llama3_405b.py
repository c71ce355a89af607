"""llama3-405b — dense GQA (kv=8), 128k vocab.  [arXiv:2407.21783]"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b", family="dense",
        n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
        d_ff=53248, vocab=128256, rope_theta=500_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-smoke", family="dense",
        n_layers=3, d_model=96, n_heads=6, n_kv_heads=2,
        d_ff=192, vocab=256, max_seq=128,
    )
