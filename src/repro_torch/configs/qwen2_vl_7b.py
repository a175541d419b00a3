"""Qwen2-VL 7B [arXiv:2409.12191; hf] — 28L d3584 28H (GQA kv=4)
d_ff=18944 vocab=152064; M-RoPE (temporal/height/width sections), dynamic
resolution. Vision frontend is a STUB: input_specs() provides precomputed
patch embeddings + 3-axis M-RoPE position ids."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    rope="mrope",
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),  # head_dim 128 -> 64 freq pairs
    norm="rmsnorm",
    embeds_input=True,
)

SMOKE = ModelConfig(
    name="qwen2vl-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    rope="mrope",
    mrope_sections=(4, 2, 2),  # head_dim 16 -> 8 freq pairs
    norm="rmsnorm",
    embeds_input=True,
    param_dtype="float32",
    compute_dtype="float32",
)
