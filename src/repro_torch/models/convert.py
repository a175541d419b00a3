"""Carry parameters across from the JAX package.

``params_from_jax`` takes the JAX parameter tree as numpy arrays (on the
JAX side, ``jax.tree.map(np.asarray, params)``) and returns the port's
parameters: the same dicts, with the stack unstacked into one dict per
layer (group g, member mi is layer g·period + mi) and DeepSeek-V3's dense
prefix (a one-tuple holding one member stacked over ``first_dense_layers``)
into one dict per layer; the MTP head comes across as it is. A MoE
member's expert tensors (``router``, ``w_in``, ``w_gate``, ``w_out`` and
``shared``) come across like any other; with sharding ``rules`` and a
``rank``, each MoE member's ``w_in``, ``w_gate`` and ``w_out`` are cut to
that rank's rows by ``moe.moe_specs``, and the router and the rest of the
model stay whole. ``opt_state_from_jax`` carries the optimizer state
(moments, step, compression error) across the same way.
Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import _device, _dtype
from repro_torch.models.moe import EXPERT_FF_DIM, local_experts


def _tensor(a, dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: torch reads it through float32, exactly
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def _tree(node, fn):
    if isinstance(node, dict):
        return {key: _tree(val, fn) for key, val in node.items()}
    return fn(node)


def _cut_experts(ffn: dict, cfg, rules, rank: int) -> dict:
    """A MoE member's expert stacks cut to ``rank``'s rows by
    ``moe.moe_specs`` on the mesh the rules describe: (data, model) with the
    model axis fastest, as ``launch.mesh.make_mesh`` lays ranks out."""
    sizes = {rules.tensor_axis: rules.model_axis_size, rules.data_axis: rules.data_axis_size}
    coords = {rules.tensor_axis: rank % rules.model_axis_size,
              rules.data_axis: rank // rules.model_axis_size % rules.data_axis_size}
    # the stacks cut as views are copied, so the whole stacks can be freed;
    # the router and the shared expert (a dict) stay as they are
    return {key: w.clone() if key in EXPERT_FF_DIM else w
            for key, w in local_experts(ffn, cfg, rules, coords, sizes).items()}


def _unstack(np_tree, cfg, conv):
    """The JAX layout's tree with ``conv`` applied to every array, the stack
    and the dense prefix unstacked into one dict per layer."""
    out = {key: _tree(np_tree[key], conv) for key in ("embed", "final_norm", "unembed", "mtp")
           if key in np_tree}
    members = np_tree["stack"]
    period = len(members)
    out["stack"] = [_tree(members[i % period], lambda a, g=i // period: conv(np.asarray(a)[g]))
                    for i in range(cfg.n_layers - cfg.first_dense_layers)]
    if "prefix" in np_tree:
        (prefix,) = np_tree["prefix"]
        out["prefix"] = [_tree(prefix, lambda a, i=i: conv(np.asarray(a)[i]))
                         for i in range(cfg.first_dense_layers)]
    return out


def params_from_jax(np_tree, cfg, device="cuda", rules=None, rank=None):
    """The port's parameters from the JAX package's tree of numpy arrays,
    in ``cfg.param_dtype`` on ``device``; with ``rules`` and ``rank``, the
    MoE experts cut to the rank's."""
    if (rules is None) != (rank is None):
        raise ValueError("give both rules and rank, or neither")
    device = _device(device)
    dt = _dtype(cfg.param_dtype)
    out = _unstack(np_tree, cfg, lambda a: _tensor(a, dt, device))
    if rules is not None:
        for layer in out["stack"]:
            if "router" in layer.get("ffn", {}):
                layer["ffn"] = _cut_experts(layer["ffn"], cfg, rules, rank)
    return out


def opt_state_from_jax(np_state, cfg, device="cuda"):
    """The port's optimizer state from the JAX package's
    (``repro.train.optimizer.init_state``, with ``err`` under gradient
    compression) as numpy arrays: ``mu``'s moments (``m`` and ``v``, or
    ``m``, ``vr`` and ``vc``) and ``err`` unstacked as ``params_from_jax``
    unstacks the parameters, each in its own dtype, and ``step``."""
    device = _device(device)

    def conv(a):
        a = np.asarray(a)
        return _tensor(a, getattr(torch, a.dtype.name), device)

    out = {"mu": _unstack(np_state["mu"], cfg, conv), "step": conv(np_state["step"])}
    if "err" in np_state:
        out["err"] = _unstack(np_state["err"], cfg, conv)
    return out
