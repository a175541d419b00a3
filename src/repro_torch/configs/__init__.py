"""Architecture registry — one module per assigned arch + the shape grid,
copied as data from the JAX package, and ``input_specs``."""

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
    input_specs,
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
    "input_specs",
]
