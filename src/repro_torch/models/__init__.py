"""Model zoo: the composable decoder of the JAX package, on torch. This
slice carries the dense attention models (GQA, sliding window, M-RoPE,
gated or GELU MLPs); MoE, MLA, Mamba and xLSTM members raise
``NotImplementedError``."""

from repro_torch.models.model import (
    init_params,
    forward_train,
    loss_fn,
    init_cache,
    decode_step,
)

__all__ = [
    "init_params",
    "forward_train",
    "loss_fn",
    "init_cache",
    "decode_step",
]
