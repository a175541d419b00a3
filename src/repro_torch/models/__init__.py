"""Model zoo: the composable decoder of the JAX package, on torch. It
carries the attention models (GQA, sliding window, M-RoPE) with gated or
GELU MLPs or a single-card MoE FFN (``models.moe``); MLA, Mamba and xLSTM
members raise ``NotImplementedError``."""

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
