"""Phi-3-mini 3.8B [arXiv:2404.14219; unverified] — 32L d3072 32H (kv=32)
d_ff=8192 vocab=32064, RoPE + SwiGLU."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    rope="rope",
    rope_theta=10000.0,
    norm="rmsnorm",
)

SMOKE = ModelConfig(
    name="phi3-smoke",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=4,
    n_kv_heads=4,
    d_ff=192,
    vocab=256,
    rope="rope",
    norm="rmsnorm",
    param_dtype="float32",
    compute_dtype="float32",
)
