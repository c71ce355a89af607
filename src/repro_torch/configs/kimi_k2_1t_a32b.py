"""kimi-k2-1t-a32b — trillion-param MoE: 384 experts top-8 (+1 shared),
GQA kv=8 per the assignment table.  [arXiv:2501.kimi2 paper-table]"""
from ..models.config import MoEConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
        head_dim=128,
        d_ff=2048, vocab=163840,
        moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048,
                      n_shared=1, impl="ep"),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="kimi-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=256, max_seq=128,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96,
                      n_shared=1, impl="dense"),
    )
