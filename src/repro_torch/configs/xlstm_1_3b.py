"""xLSTM 1.3B [arXiv:2405.04517; unverified] — 48 blocks d2048 4 heads,
xLSTM[7:1] (7 mLSTM : 1 sLSTM per group of 8); no separate FFN (d_ff=0)."""

from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    rope="none",
    norm="layernorm",
    xlstm=XLSTMConfig(proj_factor_mlstm=2.0, slstm_period=8),
)

SMOKE = ModelConfig(
    name="xlstm-smoke",
    family="ssm",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=256,
    rope="none",
    norm="layernorm",
    xlstm=XLSTMConfig(proj_factor_mlstm=2.0, slstm_period=8),
    param_dtype="float32",
    compute_dtype="float32",
)
