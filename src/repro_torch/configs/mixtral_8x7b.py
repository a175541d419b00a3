"""Mixtral 8x7B [arXiv:2401.04088; hf] — 32L d4096 32H (GQA kv=8)
d_ff=14336 vocab=32000, MoE 8 experts top-2, sliding-window attention."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    sliding_window=4096,
    rope="rope",
    rope_theta=1e6,
    norm="rmsnorm",
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336, layer_period=1),
)

SMOKE = ModelConfig(
    name="mixtral-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    sliding_window=32,
    rope="rope",
    norm="rmsnorm",
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128, layer_period=1, capacity_factor=8.0),
    param_dtype="float32",
    compute_dtype="float32",
)
