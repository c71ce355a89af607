"""xlstm-350m — sLSTM + mLSTM blocks (7:1), no separate FFN (d_ff=0).
Recurrent state (no KV growth) -> runs long_500k.  [arXiv:2405.04517]"""
from ..models.config import ModelConfig, XLSTMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="ssm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304,
        xlstm=XLSTMConfig(slstm_every=8, proj_factor=2.0, n_heads=4),
        sub_quadratic=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", family="ssm",
        n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
        d_ff=0, vocab=256, max_seq=128,
        xlstm=XLSTMConfig(slstm_every=4, proj_factor=2.0, n_heads=2),
        sub_quadratic=True,
    )
