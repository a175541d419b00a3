"""Optimizers: AdamW (full) and AdaFactor-style factored second moment
(for the 400-700B archs where full Adam state would not fit), with global
gradient-norm clipping and cosine LR schedule. Pure-functional over trees
of tensors: no ``torch.optim``.

The port of ``repro.train.optimizer``, in float32 tensors as the reference
computes (``lr_at`` on a float32 step, ``b1 ** step`` in float32). A leaf
whose gradient is ``None`` (a table the loss does not reach, as MusicGen's
``embed`` when it reads embeddings) counts as a zero gradient: its moments
still move and it still decays, as under ``jax.value_and_grad``.

The port keeps one parameter dict per layer where the JAX package stacks
each member of ``stack`` over its layer groups and the dense ``prefix``
over its layers; decay and factorability are decided on the reference's
stacked shape (``reference_ndim``). ``state_specs`` (sharding) is not
ported.
"""

from __future__ import annotations

import dataclasses
import math

import torch

#: Top-level keys whose per-layer dicts the JAX package stacks into one
#: leaf a member, with the layers on a new leading axis.
STACKED = ("stack", "prefix")


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    factored: bool = False       # AdaFactor-style v factorization
    state_dtype: str = "float32"


# ------------------------------------------------------------------ trees
def flatten(tree, path=()):
    """[(path, leaf)] of a tree of dicts, lists and tuples, depth first in
    insertion order; ``None`` counts as a leaf."""
    if isinstance(tree, dict):
        return [item for key, val in tree.items() for item in flatten(val, path + (key,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, val in enumerate(tree) for item in flatten(val, path + (i,))]
    return [(path, tree)]


def unflatten(like, leaves):
    """A tree shaped as ``like`` (lists for lists and tuples) holding
    ``leaves`` in ``flatten`` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(val) for key, val in node.items()}
        if isinstance(node, (list, tuple)):
            return [build(val) for val in node]
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def reference_ndim(path, shape) -> int:
    """The rank of the leaf in the JAX package's layout: one more than the
    port's for a leaf of ``stack`` or ``prefix`` (stacked over its layer
    groups, ``repro/models/transformer.py:stack_init``, and over
    ``first_dense_layers``, ``repro/models/model.py:init_params``).
    ``repro/train/optimizer.py:122`` decays a leaf when that rank is at
    least 2, so every such leaf decays, a norm scale too, while
    ``final_norm`` and the (un-stacked) MTP block's norms do not."""
    return len(shape) + (1 if path and path[0] in STACKED else 0)


def _factorable(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 128 and shape[-2] >= 128


def _factored_leaf(path, shape, cfg: OptConfig) -> bool:
    """``_factorable`` on the reference's shape. A stacked leaf of two or
    more dimensions factors over its own last two, as the port's does. A
    stacked 1-D leaf (G, d) would factor across its G layer groups only
    with G >= 128, which no arch of the registry reaches (Llama-3-405B's
    126 layers are the most), so it never factors."""
    if not cfg.factored:
        return False
    if path and path[0] in STACKED and len(shape) == 1:
        return False
    return _factorable(shape)


# ---------------------------------------------------------------- schedule
def lr_at(cfg: OptConfig, step):
    """The warmup-then-cosine learning rate at ``step`` (an int or a
    tensor), as a float32 tensor."""
    step = torch.as_tensor(step)
    if not step.is_floating_point():
        step = step.to(torch.int32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


# ------------------------------------------------------------------- state
def init_state(params, cfg: OptConfig):
    dt = getattr(torch, cfg.state_dtype)
    mu = []
    for path, p in flatten(params):
        if _factored_leaf(path, p.shape, cfg):
            mu.append({
                "m": torch.zeros(p.shape, dtype=dt, device=p.device),
                "vr": torch.zeros(p.shape[:-1], dtype=dt, device=p.device),   # row stats
                "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=dt, device=p.device),
            })
        else:
            mu.append({"m": torch.zeros(p.shape, dtype=dt, device=p.device),
                       "v": torch.zeros(p.shape, dtype=dt, device=p.device)})
    device = next(iter(flatten(params)))[1].device
    return {"mu": unflatten(params, mu), "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree):
    """sqrt of the float32 sum of every leaf's squares (``None`` leaves
    count as zeros)."""
    total = None
    for _, x in flatten(tree):
        if x is not None:
            s = torch.sum(torch.square(x.float()))
            total = s if total is None else total + s
    return torch.sqrt(total)


# ------------------------------------------------------------------ update
def apply_updates(params, grads, state, cfg: OptConfig):
    """One AdamW/AdaFactor step. Returns (new_params, new_state, metrics)."""
    step = state["step"] + 1
    b1, b2 = cfg.betas
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    stepf = step.float()
    c1 = 1 - b1 ** stepf
    c2 = 1 - b2 ** stepf

    def leaf(path, p, g, s):
        g = torch.zeros(p.shape, dtype=torch.float32, device=p.device) if g is None else g
        g = g.float() * scale
        m = b1 * s["m"].float() + (1 - b1) * g
        mhat = m / c1
        if "v" in s:
            v = b2 * s["v"].float() + (1 - b2) * g * g
            upd = mhat / (torch.sqrt(v / c2) + cfg.eps)
            new_s = {"m": m.to(s["m"].dtype), "v": v.to(s["v"].dtype)}
        else:
            gg = g * g
            vr = b2 * s["vr"].float() + (1 - b2) * gg.mean(-1)
            vc = b2 * s["vc"].float() + (1 - b2) * gg.mean(-2)
            rc = vr[..., None] * vc[..., None, :] / torch.clamp(
                vr.mean(-1)[..., None, None], min=1e-30)
            upd = mhat / (torch.sqrt(rc / c2) + cfg.eps)
            new_s = {"m": m.to(s["m"].dtype), "vr": vr.to(s["vr"].dtype),
                     "vc": vc.to(s["vc"].dtype)}
        if reference_ndim(path, p.shape) >= 2:  # decoupled weight decay on matrices only
            upd = upd + cfg.weight_decay * p.float()
        return (p.float() - lr * upd).to(p.dtype), new_s

    flat_p = flatten(params)
    flat_g = [get(grads, path) for path, _ in flat_p]
    flat_s = [get(state["mu"], path) for path, _ in flat_p]
    new_p, new_s = [], []
    with torch.no_grad():
        for (path, p), g, s in zip(flat_p, flat_g, flat_s):
            np_, ns = leaf(path, p, g, s)
            new_p.append(np_)
            new_s.append(ns)
    return (
        unflatten(params, new_p),
        {"mu": unflatten(params, new_s), "step": step},
        {"grad_norm": gnorm, "lr": lr},
    )
