"""jamba-1.5-large-398b — hybrid: Mamba+attention 1:7, MoE 16e top-2 every
other layer.  Sub-quadratic -> runs long_500k.  [arXiv:2403.19887]"""
from ..models.config import MambaConfig, MoEConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=24576, vocab=65536,
        attn_period=8,
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
        moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576,
                      layer_period=2, impl="ep"),
        sub_quadratic=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", family="hybrid",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, attn_period=8, max_seq=128,
        mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128,
                      layer_period=2, impl="dense"),
        sub_quadratic=True,
    )
