"""qwen1.5-110b — dense GQA (kv=8), QKV bias.  [hf:Qwen/Qwen1.5-110B]"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=49152, vocab=152064, qkv_bias=True, rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab=256, qkv_bias=True, max_seq=128,
    )
