"""Carry parameters across from the JAX package.

``params_from_jax`` takes the JAX parameter tree as numpy arrays (on the
JAX side, ``jax.tree.map(np.asarray, params)``) and returns the port's
parameters: the same dicts, with the stack unstacked into one dict per
layer (group g, member mi is layer g·period + mi). A MoE member's expert
tensors (``router``, ``w_in``, ``w_gate``, ``w_out`` and ``shared``) come
across like any other. Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import _check_supported, _device, _dtype


def _tensor(a, dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: torch reads it through float32, exactly
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def _tree(node, fn):
    if isinstance(node, dict):
        return {key: _tree(val, fn) for key, val in node.items()}
    return fn(node)


def params_from_jax(np_tree, cfg, device="cuda"):
    """The port's parameters from the JAX package's tree of numpy arrays,
    in ``cfg.param_dtype`` on ``device``."""
    _check_supported(cfg)
    device = _device(device)
    dt = _dtype(cfg.param_dtype)
    conv = lambda a: _tensor(a, dt, device)
    out = {key: _tree(np_tree[key], conv) for key in ("embed", "final_norm", "unembed")
           if key in np_tree}
    members = np_tree["stack"]
    period = len(members)
    out["stack"] = [_tree(members[i % period], lambda a, g=i // period: conv(np.asarray(a)[g]))
                    for i in range(cfg.n_layers)]
    return out
