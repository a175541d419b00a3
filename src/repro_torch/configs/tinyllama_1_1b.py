"""TinyLlama 1.1B [arXiv:2401.02385; hf] — 22L d2048 32H (GQA kv=4)
d_ff=5632 vocab=32000, llama2-style."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab=32000,
    rope="rope",
    rope_theta=10000.0,
    norm="rmsnorm",
)

SMOKE = ModelConfig(
    name="tinyllama-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    rope="rope",
    norm="rmsnorm",
    param_dtype="float32",
    compute_dtype="float32",
)
