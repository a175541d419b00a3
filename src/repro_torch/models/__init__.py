"""Model zoo: the composable decoder of the JAX package, on torch. It
carries every arch of the registry: attention members (GQA with sliding
window or M-RoPE, and DeepSeek-V3's MLA), Mamba members (``models.mamba``)
and mLSTM / sLSTM members (``models.xlstm``), with gated or GELU MLPs or
an MoE FFN (``models.moe``)."""

from repro_torch.models.model import (
    init_params,
    param_specs,
    forward_train,
    loss_fn,
    init_cache,
    cache_specs,
    decode_step,
)

__all__ = [
    "init_params",
    "param_specs",
    "forward_train",
    "loss_fn",
    "init_cache",
    "cache_specs",
    "decode_step",
]
