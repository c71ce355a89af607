"""stablelm-1.6b — dense, MHA (kv=32).  [hf:stabilityai/stablelm-2-1_6b]"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b", family="dense",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=5632, vocab=100352, rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, max_seq=128,
    )
