"""deepseek-v2-lite-16b — MLA (kv_lora=512) + MoE: 2 shared + 64 routed
top-6; first layer dense.  [arXiv:2405.04434]"""
from ..models.config import MLAConfig, MoEConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
        head_dim=128,
        d_ff=1408, vocab=102400,
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                      rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
        moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                      n_shared=2, first_dense=1, d_ff_dense=10944, impl="ep"),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16,
        d_ff=96, vocab=256, max_seq=128,
        mla=MLAConfig(kv_lora_rank=32, rope_head_dim=8,
                      nope_head_dim=16, v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96,
                      n_shared=1, first_dense=1, d_ff_dense=192, impl="dense"),
    )
