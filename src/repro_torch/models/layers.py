"""Shared layers: norms, embeddings, RoPE/M-RoPE, gated MLPs.

The port of ``repro.models.layers``: each layer is an init that returns a
dict of tensors (``truncated_normal`` draws from a ``torch.Generator`` on
the tensors' device) and an apply that is a plain function of (params, x).
Norms and RoPE compute in float32 and cast back to the input's dtype, as
the JAX package does. Sharding specs are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def truncated_normal(gen: torch.Generator, shape, dtype, scale, device):
    """``scale`` times a standard normal truncated to [-2, 2], drawn in
    float32, scaled in place (one float32 copy, not two, of a 256-expert
    stack) and cast to ``dtype``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(scale).to(dtype)


# ----------------------------------------------------------------- norms
def rmsnorm_init(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps=1e-5):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm_init(d, dtype, device, elementwise=True):
    if not elementwise:  # olmo's non-parametric LN
        return {}
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params, x, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if "scale" in params:
        y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def make_norm(kind: str, d: int, dtype, device):
    if kind == "rmsnorm":
        return rmsnorm_init(d, dtype, device), rmsnorm
    if kind == "layernorm":
        return layernorm_init(d, dtype, device), layernorm
    if kind == "nonparametric":  # olmo
        return layernorm_init(d, dtype, device, elementwise=False), layernorm
    raise ValueError(kind)


# ------------------------------------------------------------------ RoPE
def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate(x, ang):
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (hd/2,)
    ang = positions[..., None].float() * freqs  # (..., seq, hd/2)
    return _rotate(x, ang[..., None, :])  # broadcast over heads


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, sections: tuple[int, int, int],
                theta: float = 10000.0):
    """Qwen2-VL multimodal RoPE. positions3: (3, ..., seq) — temporal,
    height, width position ids; sections: per-axis frequency-pair counts
    summing to head_dim/2 (e.g. (16, 24, 24) for head_dim 128)."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"mrope sections {sections} do not sum to head_dim/2 = {hd // 2}")
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    # split frequency pairs among the three position streams
    sec_ids = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device)
                         for i, s in enumerate(sections)])  # (hd/2,)
    pos = torch.movedim(positions3[sec_ids], 0, -1)  # (..., seq, hd/2)
    ang = pos.float() * freqs
    return _rotate(x, ang[..., None, :])


# ------------------------------------------------------------------- MLP
def mlp_init(gen, d_model, d_ff, dtype, device, gated=True):
    scale_in = d_model ** -0.5
    scale_out = d_ff ** -0.5
    p = {
        "w_in": truncated_normal(gen, (d_model, d_ff), dtype, scale_in, device),
        "w_out": truncated_normal(gen, (d_ff, d_model), dtype, scale_out, device),
    }
    if gated:
        p["w_gate"] = truncated_normal(gen, (d_model, d_ff), dtype, scale_in, device)
    return p


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_apply(params, x, act=F.silu):
    h = x @ params["w_in"]
    if "w_gate" in params:
        h = act(x @ params["w_gate"]) * h
    else:
        h = act(h)
    return h @ params["w_out"]


# ------------------------------------------------------------- embedding
def embed_init(gen, vocab, d_model, dtype, device):
    return {"table": truncated_normal(gen, (vocab, d_model), dtype, 1.0, device)}


def embed_apply(params, tokens):
    return params["table"][tokens]


def unembed_apply(params, x):
    return x @ params["table"].T
