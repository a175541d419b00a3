"""Jamba 1.5 Large 398B [arXiv:2403.19887; hf] — 72L d8192 64H (GQA kv=8)
d_ff=24576 vocab=65536; Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer."""

from repro_torch.configs.base import ModelConfig, MoEConfig, MambaConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    rope="none",  # jamba uses no positional embeddings (Mamba carries order)
    norm="rmsnorm",
    attn_period=8,  # 1 attention : 7 mamba
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, dt_rank=512),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576, layer_period=2),
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    family="hybrid",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    rope="none",
    norm="rmsnorm",
    attn_period=8,
    mamba=MambaConfig(d_state=8, d_conv=4, expand=2, dt_rank=8),
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128, layer_period=2, capacity_factor=8.0),
    param_dtype="float32",
    compute_dtype="float32",
)
