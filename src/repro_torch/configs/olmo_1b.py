"""OLMo 1B [arXiv:2402.00838; hf] — 16L d2048 16H d_ff=8192 vocab=50304,
non-parametric LayerNorm, tied embeddings."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    rope="rope",
    rope_theta=10000.0,
    norm="nonparametric",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="olmo-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    rope="rope",
    norm="nonparametric",
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="float32",
)
