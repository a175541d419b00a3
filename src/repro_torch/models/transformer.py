"""Composable decoder: blocks = mixer + optional FFN, pre-norm residual.

The port of ``repro.models.transformer`` for ``attn`` mixers with dense
``mlp`` or ``moe`` FFNs, in the train (full sequence) and decode (one
token, cache) forms. The JAX package stacks layers as repeating groups and
scans them with ``lax.scan`` under ``jax.checkpoint``; here the stack is a
list with one parameter dict per layer, in the JAX stack's order (group g,
member mi is layer g·period + mi), walked by a Python loop. There is no
remat: nothing runs backward yet. A ``moe`` FFN takes
``moe.moe_apply_auto`` with no mesh, the sparse dispatch of one card; its
load-balance loss is summed over the stack in train form and dropped in
decode form, as in the JAX package. ``mamba``, ``mlstm`` and ``slstm``
members raise ``NotImplementedError``, and so does MLA (``models.model``
refuses its configs).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE

_WAITING = {
    "mamba": "the Mamba mixer (models/mamba.py)",
    "mlstm": "the mLSTM mixer (models/xlstm.py)",
    "slstm": "the sLSTM mixer (models/xlstm.py)",
}


def _check_kinds(mixer: str, ffn: str) -> None:
    if mixer in _WAITING:
        raise NotImplementedError(f"{_WAITING[mixer]} is not ported yet: ROADMAP Queue 1 item 5")
    if mixer != "attn" or ffn not in ("mlp", "moe", "none"):
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
        p["ffn"] = MOE.moe_init(gen, cfg, dtype, device) if ffn == "moe" else L.mlp_init(
            gen, cfg.d_model, cfg.d_ff, dtype, device, gated=cfg.mlp_gated)
    return p


def _norm(cfg):
    return L.rmsnorm if cfg.norm == "rmsnorm" else L.layernorm


def _act(cfg):
    return F.silu if cfg.mlp_gated else L.gelu


def _ffn(params, h2, cfg, ffn):
    """(y, aux) of the member's FFN on its post-norm2 hidden."""
    if ffn == "moe":
        return MOE.moe_apply_auto(params, h2, cfg)
    return L.mlp_apply(params, h2, act=_act(cfg)), None


def member_train(params, x, cfg, mixer, ffn, positions, mrope_positions, use_kernel):
    """-> (x, aux): aux is the MoE load-balance loss, a float32 zero for
    any other FFN."""
    _check_kinds(mixer, ffn)
    norm = _norm(cfg)
    h = norm(params["norm1"], x)
    x = x + A.gqa_train(params["mixer"], h, cfg, positions, mrope_positions, use_kernel)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn != "none":
        y, moe_aux = _ffn(params["ffn"], norm(params["norm2"], x), cfg, ffn)
        x = x + y
        if moe_aux is not None:
            aux = moe_aux
    return x, aux


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
        y, _ = _ffn(params["ffn"], _norm(cfg)(params["norm2"], x), cfg, ffn)
        x = x + y
    return x, cache


def member_cache_init(cfg, mixer, batch, max_seq, dtype, device):
    _check_kinds(mixer, "none")
    return A.gqa_cache_init(cfg, batch, max_seq, dtype, device)


# -------------------------------------------------------------- the stack
def stack_init(gen, cfg, dtype, device):
    """One parameter dict per layer of the main stack."""
    return [member_init(gen, cfg, mixer, ffn, dtype, device) for mixer, ffn in layer_kinds(cfg)]


def stack_train(stack_params, x, cfg, positions, mrope_positions=None, use_kernel=True):
    """-> (x, the float32 sum of the members' aux losses)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for params, (mixer, ffn) in zip(stack_params, layer_kinds(cfg)):
        x, aux = member_train(params, x, cfg, mixer, ffn, positions, mrope_positions, use_kernel)
        aux_total = aux_total + aux
    return x, aux_total


def stack_decode(stack_params, x, caches, cfg, position, mrope_positions=None):
    new_caches = []
    for params, cache, (mixer, ffn) in zip(stack_params, caches, layer_kinds(cfg)):
        x, cache = member_decode(params, x, cache, cfg, mixer, ffn, position, mrope_positions)
        new_caches.append(cache)
    return x, new_caches


def stack_cache_init(cfg, batch, max_seq, dtype, device):
    return [member_cache_init(cfg, mixer, batch, max_seq, dtype, device)
            for mixer, _ in layer_kinds(cfg)]
