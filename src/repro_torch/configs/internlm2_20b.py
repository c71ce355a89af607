"""internlm2-20b — dense GQA (kv=8).  [arXiv:2403.17297]"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b", family="dense",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab=92544, rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-smoke", family="dense",
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
        d_ff=192, vocab=256, max_seq=128,
    )
