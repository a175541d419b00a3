"""Composable decoder: blocks = mixer + optional FFN, pre-norm residual.

The port of ``repro.models.transformer``: ``attn`` mixers (GQA, or MLA
where ``cfg.attention == "mla"``), ``mamba`` (``models.mamba``) and
``mlstm`` / ``slstm`` (``models.xlstm``), with dense ``mlp``, ``moe`` or no
FFN, in the train (full sequence) and decode (one token, cache or
recurrent state) forms. The JAX package stacks layers as repeating groups
and scans them with ``lax.scan`` under ``jax.checkpoint``; here the stack
is a list with one parameter dict per layer, in the JAX stack's order
(group g, member mi is layer g·period + mi), walked by a Python loop.
With ``remat`` (the default) and autograd recording, the train form runs
each group of ``period`` layers under ``torch.utils.checkpoint`` (non
reentrant), as the JAX package runs ``jax.checkpoint(group_fn)``: the
backward recomputes a group's activations from its input. The decode form is a
generator that pauses at each MoE member (``stack_decode_staged``);
``serve_inline`` answers it with the FFN computed inline, the multi-tenant
fleet with one combined replay a boundary. A ``moe`` FFN takes
``moe.moe_apply_auto``: the sparse dispatch of one card, or, with sharding
rules active (``dist.sharding.set_active``), the expert-parallel or
tensor-parallel path on this rank's data shard; its load-balance loss is
summed over the stack in train form and dropped in decode form, as in the
JAX package. An attention member's decode writes its KV cache in place; a
recurrent member's returns a new state. Under active rules the train form
is tensor-parallel on the rank's cut leaves (every mixer, attention,
Mamba, mLSTM or sLSTM, and the dense FFNs), with the reference's
``seq_parallel`` (``member_train``); so is the decode form
(``decode_tp``: the identity in and the sum out, whatever
``seq_parallel`` says), each attention cache the rank's block of the
sequence and each recurrent state the rank's block of its inner or
feature dim (``stack_cache_specs``), never gathered.

The sharding specs (``member_specs``, ``stack_specs``,
``stack_cache_specs``) follow the port's trees: one spec dict per layer,
each the JAX package's stacked spec without its leading (layer group)
entry, layer i taking member i % period.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.dist import collectives as CL
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


def member_specs(cfg, rules, mixer: str, ffn: str):
    _check_kinds(mixer, ffn)
    s = {"norm1": L.norm_specs(cfg.norm)}
    if mixer == "attn":
        s["mixer"] = A.mla_specs(cfg, rules) if cfg.attention == "mla" else A.gqa_specs(cfg, rules)
    elif mixer == "mamba":
        s["mixer"] = MB.mamba_specs(cfg, rules)
    elif mixer == "mlstm":
        s["mixer"] = XL.mlstm_specs(cfg, rules)
    else:
        s["mixer"] = XL.slstm_specs(cfg, rules)
    if ffn != "none":
        s["norm2"] = L.norm_specs(cfg.norm)
        s["ffn"] = MOE.moe_specs(cfg, rules) if ffn == "moe" else L.mlp_specs(
            rules, gated=cfg.mlp_gated)
    return s


def _norm(cfg):
    return L.rmsnorm if cfg.norm == "rmsnorm" else L.layernorm


def _act(cfg):
    return F.silu if cfg.mlp_gated else L.gelu


def _ffn(params, h2, cfg, ffn, tp=None):
    """(y, aux) of the member's FFN on its post-norm2 hidden; a dense FFN
    runs under the profiler label ``ffn.mlp``. With ``tp`` (the train path
    under active rules) a dense FFN and a MoE layer's shared expert run on
    the rank's cut leaves (``layers.mlp_apply``); the routed experts take
    ``moe.moe_apply_auto`` (EP or TP) on the whole hidden (under
    ``seq_parallel`` the gathered sequence, ``_whole``). The shared expert
    is added after the routed experts, as the reference adds it after its
    ``shard_map``."""
    if ffn != "moe":
        with record_function("ffn.mlp"):
            return L.mlp_apply(params, h2, act=_act(cfg), tp=tp, ff=cfg.d_ff), None
    if tp is None:
        return MOE.moe_apply_auto(params, h2, cfg)
    routed = {key: w for key, w in params.items() if key != "shared"}
    y, aux = _whole(lambda h: MOE.moe_apply_auto(routed, h, cfg), h2, tp)
    if "shared" in params:
        y = y + L.mlp_apply(params["shared"], h2, tp=tp,
                            ff=cfg.moe.d_ff_expert * cfg.moe.shared_experts)
    return y, aux


def _whole(fn, h, tp):
    """``fn`` (the routed experts, which take their own EP or TP path) on
    the rank's rows: under ``seq_parallel`` on the gathered sequence, and
    its output cut back to the rank's block."""
    if tp is None or not tp.seq_parallel:
        return fn(h)
    out = fn(tp.gather_seq(h))
    if isinstance(out, tuple):
        return (tp.own_seq(out[0]), *out[1:])
    return tp.own_seq(out)


def member_train(params, x, cfg, mixer, ffn, positions, mrope_positions, use_kernel):
    """-> (x, aux): aux is the MoE load-balance loss, a float32 zero for
    any other FFN.

    Under active rules (``dist.collectives.tensor_parallel``) the mixer
    (GQA, MLA, Mamba, mLSTM or sLSTM), the dense MLP and a MoE layer's
    shared expert run on the rank's leaves cut on the tensor axis (their
    specs' cuts; a whole leaf raises ``ValueError`` naming it), their
    partial outputs summed over the axis, and the MoE layer's experts take
    the EP or TP path. With ``seq_parallel`` the residual ``x`` is the
    rank's (B, S / m, d) block of the sequence: each norm runs on the
    block, the sequence is gathered before the mixer and the FFN, and
    their output reduce-scattered back to the block (the routed experts,
    on whole rows: their output cut to the block)."""
    _check_kinds(mixer, ffn)
    tp = CL.tensor_parallel()
    norm = _norm(cfg)
    h = norm(params["norm1"], x)
    if mixer in RECURRENT:
        x = x + _RECURRENT[mixer][1](params["mixer"], h, cfg, tp=tp)
    elif cfg.attention == "mla":
        x = x + A.mla_train(params["mixer"], h, cfg, positions, use_kernel=use_kernel, tp=tp)
    else:
        x = x + A.gqa_train(params["mixer"], h, cfg, positions, mrope_positions, use_kernel,
                            tp=tp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn != "none":
        y, moe_aux = _ffn(params["ffn"], norm(params["norm2"], x), cfg, ffn, tp)
        x = x + y
        if moe_aux is not None:
            aux = moe_aux
    return x, aux


def decode_tp():
    """The active mesh's tensor axis as the decode computes on it
    (``TensorParallel.for_decode``), or None with no rules active."""
    tp = CL.tensor_parallel()
    return None if tp is None else tp.for_decode()


def member_decode_mixer(params, x, cache, cfg, mixer, position, mrope_positions):
    """The mixer half of one decode member: pre-norm mixer + residual.
    Returns (x, cache) — the FFN half (if any) applies on top. Under active
    rules (``decode_tp``) the mixer runs on the rank's cut leaves: an
    attention mixer on its block of the sequence of the cache
    (``attention``'s module docstring), a Mamba, mLSTM or sLSTM mixer on
    the rank's shard of its state (``stack_cache_specs``; ``mamba`` and
    ``xlstm``'s module docstrings)."""
    _check_kinds(mixer, "none")
    h = _norm(cfg)(params["norm1"], x)
    if mixer in RECURRENT:
        mx, cache = _RECURRENT[mixer][2](params["mixer"], h, cache, cfg, tp=decode_tp())
    elif cfg.attention == "mla":
        mx, cache = A.mla_decode(params["mixer"], h, cache, cfg, position, tp=decode_tp())
    else:
        mx, cache = A.gqa_decode(params["mixer"], h, cache, cfg, position, mrope_positions,
                                 tp=decode_tp())
    return x + mx, cache


def member_decode(params, x, cache, cfg, mixer, ffn, position, mrope_positions):
    """One decode member with its FFN computed inline (under active rules
    as ``member_train``'s, on one token a row). Returns (x, cache)."""
    x, cache = member_decode_mixer(params, x, cache, cfg, mixer, position, mrope_positions)
    if ffn != "none":
        x = x + _ffn(params["ffn"], _norm(cfg)(params["norm2"], x), cfg, ffn, decode_tp())[0]
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


def stack_specs(cfg, rules):
    """One spec dict per layer of the main stack, as ``stack_init`` lays
    the parameters out."""
    return [member_specs(cfg, rules, mixer, ffn) for mixer, ffn in layer_kinds(cfg)]


def remat_call(fn, x, remat: bool):
    """``fn(x)``, under ``torch.utils.checkpoint`` when ``remat`` is set and
    autograd is recording (so the backward recomputes what ``fn`` made)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, x, use_reentrant=False)
    return fn(x)


def stack_train(stack_params, x, cfg, positions, mrope_positions=None, use_kernel=True,
                remat: bool = True):
    """-> (x, the float32 sum of the members' aux losses); ``remat``
    checkpoints each group of ``period`` layers. A group runs under the
    profiler label ``stack.group`` (in the backward's recompute too)."""
    kinds = layer_kinds(cfg)
    period = len(cfg.layer_kinds())
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for g0 in range(0, len(stack_params), period):
        def group_fn(x, layers=stack_params[g0:g0 + period], kinds=kinds[g0:g0 + period]):
            with record_function("stack.group"):
                aux = None
                for params, (mixer, ffn) in zip(layers, kinds):
                    x, a = member_train(params, x, cfg, mixer, ffn, positions, mrope_positions,
                                        use_kernel)
                    aux = a if aux is None else aux + a
                return x, aux

        x, aux = remat_call(group_fn, x, remat)
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
    them all with one combined program replay a boundary round. Under
    active rules the mixers and dense FFNs run as ``member_decode``'s."""
    norm = _norm(cfg)
    tp = decode_tp()
    new_caches = []
    for params, cache, (mixer, ffn) in zip(stack_params, caches, layer_kinds(cfg)):
        x, cache = member_decode_mixer(params, x, cache, cfg, mixer, position, mrope_positions)
        new_caches.append(cache)
        if ffn == "moe":
            y = yield (params["ffn"], norm(params["norm2"], x))
            x = x + torch.as_tensor(y).to(device=x.device, dtype=x.dtype)
        elif ffn != "none":
            x = x + _ffn(params["ffn"], norm(params["norm2"], x), cfg, ffn, tp)[0]
    return x, new_caches


def serve_inline(staged, cfg):
    """Run a staged decode (``stack_decode_staged`` or
    ``model.decode_step_staged``) to its end, answering each MoE boundary
    with the FFN computed inline (``moe.moe_apply_auto``; under active
    rules the shared expert on the rank's cut, as ``_ffn``'s). Returns the
    generator's value."""
    tp = decode_tp()
    y = None
    while True:
        try:
            ffn_params, h2 = staged.send(y)
        except StopIteration as stop:
            return stop.value
        y = _ffn(ffn_params, h2, cfg, "moe", tp)[0]


def stack_cache_init(cfg, batch, max_seq, dtype, device):
    return [member_cache_init(cfg, mixer, batch, max_seq, dtype, device)
            for mixer, _ in layer_kinds(cfg)]


def _member_cache_specs(cfg, rules, mixer):
    b, t = rules.batch_axes, rules.tensor_axis
    if mixer == "attn":
        if cfg.attention == "mla":
            return {"c_kv": (b, t, None), "k_rope": (b, t, None)}  # (B, S, r)
        return {"k": (b, None, t, None), "v": (b, None, t, None)}  # (B, kvh, S, hd)
    if mixer == "mamba":
        return {"conv": (b, None, t), "ssm": (b, t, None)}  # (B, d_conv-1, di), (B, di, N)
    if mixer == "mlstm":
        return {"C": (b, None, t, None), "n": (b, None, t), "m": (b, None)}  # (B, H, dh, dh)
    return {"c": (b, t), "n": (b, t), "h": (b, t), "m": (b, t)}  # sLSTM: (B, d)


def stack_cache_specs(cfg, rules, long_context: bool):
    """One spec dict per layer's decode state, as ``stack_cache_init`` lays
    them out. Attention caches are sequence-sharded over the tensor axis
    (KV head counts like 8 do not divide a 16-wide model axis; the
    sequence always does); recurrent states shard their inner or feature
    dims. ``long_context`` changes nothing, as in the JAX package."""
    return [_member_cache_specs(cfg, rules, mixer) for mixer, _ in layer_kinds(cfg)]
