"""MusicGen-Large [arXiv:2306.05284; hf] — 48L d2048 32H d_ff=8192
vocab=2048 decoder-only over EnCodec tokens. The EnCodec frontend is a
STUB: input_specs() provides precomputed frame embeddings (positional
information included by the frontend, hence rope='none'); plain GELU MLP
(non-gated), LayerNorm — T5-style decoder."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    rope="none",
    norm="layernorm",
    mlp_gated=False,
    embeds_input=True,
)

SMOKE = ModelConfig(
    name="musicgen-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=64,
    rope="none",
    norm="layernorm",
    mlp_gated=False,
    embeds_input=True,
    param_dtype="float32",
    compute_dtype="float32",
)
