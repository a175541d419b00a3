"""Architecture registry — one module per assigned arch + the shape grid,
copied as data from the JAX package (``input_specs`` stays there)."""

from repro_torch.configs.base import (
    ModelConfig,
    MoEConfig,
    MLAConfig,
    MambaConfig,
    XLSTMConfig,
    ShapeConfig,
    SHAPES,
    ARCH_IDS,
    LONG_CONTEXT_OK,
    get_config,
    get_smoke_config,
    cell_supported,
)

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "MLAConfig",
    "MambaConfig",
    "XLSTMConfig",
    "ShapeConfig",
    "SHAPES",
    "ARCH_IDS",
    "LONG_CONTEXT_OK",
    "get_config",
    "get_smoke_config",
    "cell_supported",
]
