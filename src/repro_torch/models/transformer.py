"""Composable decoder: blocks = mixer + optional FFN, pre-norm residual.

The port of ``repro.models.transformer`` for ``attn`` mixers with dense
``mlp`` FFNs, in the train (full sequence) and decode (one token, cache)
forms. The JAX package stacks layers as repeating groups and scans them
with ``lax.scan`` under ``jax.checkpoint``; here the stack is a list with
one parameter dict per layer, in the JAX stack's order (group g, member
mi is layer g·period + mi), walked by a Python loop. There is no remat:
nothing runs backward yet. ``moe``, ``mamba``, ``mlstm`` and ``slstm``
members raise ``NotImplementedError``, and so does MLA
(``models.model`` refuses its configs).
"""

from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models import attention as A
from repro_torch.models import layers as L

_WAITING = {
    "moe": "the MoE FFN (models/moe.py: EP, TP and guest modes)",
    "mamba": "the Mamba mixer (models/mamba.py)",
    "mlstm": "the mLSTM mixer (models/xlstm.py)",
    "slstm": "the sLSTM mixer (models/xlstm.py)",
}


def _check_kinds(mixer: str, ffn: str) -> None:
    for kind in (mixer, ffn):
        if kind in _WAITING:
            raise NotImplementedError(f"{_WAITING[kind]} is not ported yet: ROADMAP Queue 1 item 8")
    if mixer != "attn" or ffn not in ("mlp", "none"):
        raise ValueError(f"unknown layer kind ({mixer}, {ffn})")


def layer_kinds(cfg) -> list[tuple[str, str]]:
    """(mixer, ffn) of every layer of the main stack, in order."""
    return cfg.layer_kinds() * cfg.n_groups


# ------------------------------------------------------------ one member
def member_init(gen, cfg, mixer: str, ffn: str, dtype, device):
    _check_kinds(mixer, ffn)
    p = {"norm1": L.make_norm(cfg.norm, cfg.d_model, dtype, device)[0]}
    p["mixer"] = A.gqa_init(gen, cfg, dtype, device)
    if ffn != "none":
        p["norm2"] = L.make_norm(cfg.norm, cfg.d_model, dtype, device)[0]
        p["ffn"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device, gated=cfg.mlp_gated)
    return p


def _norm(cfg):
    return L.rmsnorm if cfg.norm == "rmsnorm" else L.layernorm


def _act(cfg):
    return F.silu if cfg.mlp_gated else L.gelu


def member_train(params, x, cfg, mixer, ffn, positions, mrope_positions, use_kernel):
    _check_kinds(mixer, ffn)
    norm = _norm(cfg)
    h = norm(params["norm1"], x)
    x = x + A.gqa_train(params["mixer"], h, cfg, positions, mrope_positions, use_kernel)
    if ffn != "none":
        h2 = norm(params["norm2"], x)
        x = x + L.mlp_apply(params["ffn"], h2, act=_act(cfg))
    return x


def member_decode_mixer(params, x, cache, cfg, mixer, position, mrope_positions):
    """The mixer half of one decode member: pre-norm mixer + residual.
    Returns (x, cache) — the FFN half (if any) applies on top."""
    _check_kinds(mixer, "none")
    h = _norm(cfg)(params["norm1"], x)
    mx, cache = A.gqa_decode(params["mixer"], h, cache, cfg, position, mrope_positions)
    return x + mx, cache


def member_decode(params, x, cache, cfg, mixer, ffn, position, mrope_positions):
    x, cache = member_decode_mixer(params, x, cache, cfg, mixer, position, mrope_positions)
    if ffn != "none":
        h2 = _norm(cfg)(params["norm2"], x)
        x = x + L.mlp_apply(params["ffn"], h2, act=_act(cfg))
    return x, cache


def member_cache_init(cfg, mixer, batch, max_seq, dtype, device):
    _check_kinds(mixer, "none")
    return A.gqa_cache_init(cfg, batch, max_seq, dtype, device)


# -------------------------------------------------------------- the stack
def stack_init(gen, cfg, dtype, device):
    """One parameter dict per layer of the main stack."""
    return [member_init(gen, cfg, mixer, ffn, dtype, device) for mixer, ffn in layer_kinds(cfg)]


def stack_train(stack_params, x, cfg, positions, mrope_positions=None, use_kernel=True):
    for params, (mixer, ffn) in zip(stack_params, layer_kinds(cfg)):
        x = member_train(params, x, cfg, mixer, ffn, positions, mrope_positions, use_kernel)
    return x


def stack_decode(stack_params, x, caches, cfg, position, mrope_positions=None):
    new_caches = []
    for params, cache, (mixer, ffn) in zip(stack_params, caches, layer_kinds(cfg)):
        x, cache = member_decode(params, x, cache, cfg, mixer, ffn, position, mrope_positions)
        new_caches.append(cache)
    return x, new_caches


def stack_cache_init(cfg, batch, max_seq, dtype, device):
    return [member_cache_init(cfg, mixer, batch, max_seq, dtype, device)
            for mixer, _ in layer_kinds(cfg)]
