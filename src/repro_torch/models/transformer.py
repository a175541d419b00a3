"""Composable decoder: blocks = mixer + optional FFN, pre-norm residual.

The port of ``repro.models.transformer``: ``attn`` mixers (GQA, or MLA
where ``cfg.attention == "mla"``), ``mamba`` (``models.mamba``) and
``mlstm`` / ``slstm`` (``models.xlstm``), with dense ``mlp``, ``moe`` or no
FFN, in the train (full sequence) and decode (one token, cache or
recurrent state) forms. The JAX package stacks layers as repeating groups
and scans them with ``lax.scan`` under ``jax.checkpoint``; here the stack
is a list with one parameter dict per layer, in the JAX stack's order
(group g, member mi is layer g·period + mi), walked by a Python loop.
There is no remat: nothing runs backward yet. The decode form is a
generator that pauses at each MoE member (``stack_decode_staged``);
``serve_inline`` answers it with the FFN computed inline, the multi-tenant
fleet with one combined replay a boundary. A ``moe`` FFN takes
``moe.moe_apply_auto``: the sparse dispatch of one card, or, with sharding
rules active (``dist.sharding.set_active``), the expert-parallel or
tensor-parallel path on this rank's data shard; its load-balance loss is
summed over the stack in train form and dropped in decode form, as in the
JAX package. An attention member's decode writes its KV cache in place; a
recurrent member's returns a new state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.profiler import record_function

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models import moe as MOE
from repro_torch.models import xlstm as XL

#: The recurrent mixers (their decode state is not masked by position):
#: (init, train, decode, state init) of each.
_RECURRENT = {
    "mamba": (MB.mamba_init, MB.mamba_train, MB.mamba_decode, MB.mamba_state_init),
    "mlstm": (XL.mlstm_init, XL.mlstm_train, XL.mlstm_decode, XL.mlstm_state_init),
    "slstm": (XL.slstm_init, XL.slstm_train, XL.slstm_decode, XL.slstm_state_init),
}
RECURRENT = tuple(_RECURRENT)


def _check_kinds(mixer: str, ffn: str) -> None:
    if mixer not in ("attn",) + RECURRENT or ffn not in ("mlp", "moe", "none"):
        raise ValueError(f"unknown layer kind ({mixer}, {ffn})")


def layer_kinds(cfg) -> list[tuple[str, str]]:
    """(mixer, ffn) of every layer of the main stack, in order."""
    return cfg.layer_kinds() * cfg.n_groups


# ------------------------------------------------------------ one member
def member_init(gen, cfg, mixer: str, ffn: str, dtype, device):
    _check_kinds(mixer, ffn)
    p = {"norm1": L.make_norm(cfg.norm, cfg.d_model, dtype, device)[0]}
    if mixer in RECURRENT:
        init = _RECURRENT[mixer][0]
    else:
        init = A.mla_init if cfg.attention == "mla" else A.gqa_init
    p["mixer"] = init(gen, cfg, dtype, device)
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
    """(y, aux) of the member's FFN on its post-norm2 hidden; a dense FFN
    runs under the profiler label ``ffn.mlp``."""
    if ffn == "moe":
        return MOE.moe_apply_auto(params, h2, cfg)
    with record_function("ffn.mlp"):
        return L.mlp_apply(params, h2, act=_act(cfg)), None


def member_train(params, x, cfg, mixer, ffn, positions, mrope_positions, use_kernel):
    """-> (x, aux): aux is the MoE load-balance loss, a float32 zero for
    any other FFN."""
    _check_kinds(mixer, ffn)
    norm = _norm(cfg)
    h = norm(params["norm1"], x)
    if mixer in RECURRENT:
        x = x + _RECURRENT[mixer][1](params["mixer"], h, cfg)
    elif cfg.attention == "mla":
        x = x + A.mla_train(params["mixer"], h, cfg, positions, use_kernel=use_kernel)
    else:
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
    if mixer in RECURRENT:
        mx, cache = _RECURRENT[mixer][2](params["mixer"], h, cache, cfg)
    elif cfg.attention == "mla":
        mx, cache = A.mla_decode(params["mixer"], h, cache, cfg, position)
    else:
        mx, cache = A.gqa_decode(params["mixer"], h, cache, cfg, position, mrope_positions)
    return x + mx, cache


def member_decode(params, x, cache, cfg, mixer, ffn, position, mrope_positions):
    """One decode member with its FFN computed inline. Returns (x, cache)."""
    x, cache = member_decode_mixer(params, x, cache, cfg, mixer, position, mrope_positions)
    if ffn != "none":
        x = x + _ffn(params["ffn"], _norm(cfg)(params["norm2"], x), cfg, ffn)[0]
    return x, cache


def member_cache_init(cfg, mixer, batch, max_seq, dtype, device):
    """A member's decode state: a KV (or latent) cache of ``max_seq``
    positions for attention, a recurrent state for the other mixers (all
    zeros)."""
    _check_kinds(mixer, "none")
    if mixer in RECURRENT:
        return _RECURRENT[mixer][3](cfg, batch, dtype, device)
    if cfg.attention == "mla":
        return A.mla_cache_init(cfg, batch, max_seq, dtype, device)
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


def stack_decode_staged(stack_params, x, caches, cfg, position, mrope_positions=None):
    """The decode form of the stack, as a generator that pauses at every
    MoE member: instead of computing the expert FFN inline it yields
    ``(ffn_params, h2)``, the member's expert weights and its post-norm2
    hidden, and expects the expert output ``y`` sent back (``gen.send(y)``:
    a tensor or a NumPy array of h2's shape), which it adds to the residual
    stream, cast to its dtype. Returns (x, new_caches) through
    ``StopIteration.value``.

    ``serve_inline`` drives it with each boundary's FFN computed inline
    (``model.decode_step``); the multi-tenant fleet
    (``serve.fleet.TenantFleet``) collects N tenants' yields and serves
    them all with one combined program replay a boundary round."""
    norm = _norm(cfg)
    new_caches = []
    for params, cache, (mixer, ffn) in zip(stack_params, caches, layer_kinds(cfg)):
        x, cache = member_decode_mixer(params, x, cache, cfg, mixer, position, mrope_positions)
        new_caches.append(cache)
        if ffn == "moe":
            y = yield (params["ffn"], norm(params["norm2"], x))
            x = x + torch.as_tensor(y).to(device=x.device, dtype=x.dtype)
        elif ffn != "none":
            x = x + _ffn(params["ffn"], norm(params["norm2"], x), cfg, ffn)[0]
    return x, new_caches


def serve_inline(staged, cfg):
    """Run a staged decode (``stack_decode_staged`` or
    ``model.decode_step_staged``) to its end, answering each MoE boundary
    with the FFN computed inline (``moe.moe_apply_auto``). Returns the
    generator's value."""
    y = None
    while True:
        try:
            ffn_params, h2 = staged.send(y)
        except StopIteration as stop:
            return stop.value
        y = _ffn(ffn_params, h2, cfg, "moe")[0]


def stack_cache_init(cfg, batch, max_seq, dtype, device):
    return [member_cache_init(cfg, mixer, batch, max_seq, dtype, device)
            for mixer, _ in layer_kinds(cfg)]
