"""DeepSeek-V3 671B [arXiv:2412.19437; hf] — 61L d7168 128H MLA
d_ff(dense)=18432, MoE 1 shared + 256 routed top-8 (expert ff 2048), MTP."""

from repro_torch.configs.base import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,          # dense-prefix FFN
    vocab=129280,
    attention="mla",
    head_dim=192,        # qk_nope 128 + qk_rope 64
    rope="rope",
    rope_theta=10000.0,
    norm="rmsnorm",
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=256, top_k=8, d_ff_expert=2048, shared_experts=1, layer_period=1
    ),
    first_dense_layers=3,
    mtp_depth=1,
)

SMOKE = ModelConfig(
    name="deepseek-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    attention="mla",
    head_dim=24,
    rope="rope",
    norm="rmsnorm",
    mla=MLAConfig(
        q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16,
    ),
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=32, shared_experts=1, layer_period=1, capacity_factor=8.0),
    first_dense_layers=1,
    mtp_depth=1,
    param_dtype="float32",
    compute_dtype="float32",
)
