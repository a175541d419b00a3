"""Mixture-of-Experts on one card: top-k router, shared experts, the
dense-dispatch formulation and the capacity-bounded sparse dispatch.

The port of the single-device half of ``repro.models.moe``. Parameters
are the JAX package's: ``router`` (d, E), ``w_in`` and ``w_gate``
(E, d, ff), ``w_out`` (E, ff, d) and, with shared experts, a gated MLP
``shared``. The dispatch and combine scatters are torch's
``index_put_``/``index_add_`` and the expert products ``torch.bmm``: the
JAX package computes them as plain scatters and einsums, outside any
Pallas kernel, so this layer has no kernel of its own.

What has to match the reference exactly:

* the expert order on ties: ``jax.lax.top_k`` takes the lower expert
  index first; ``torch.topk`` promises no order on ties, so ``router_topk``
  takes the first k of a stable descending sort;
* the capacity ``C = max(1, int(cf·T·k/E))`` rounded up to a multiple of
  16, a (token, k) entry's slot its running count in its expert over the
  flattened (t, k) order, and ``keep = slot < C``;
* dropped entries add zeros at the clipped slot ``C - 1``, as the
  reference's ``.at[].add`` does (no masking of the write itself);
* the combine accumulates in float32 and casts back once.

The expert-parallel path ``moe_apply_ep`` runs on every rank of a
process mesh registered by ``dist.sharding.set_active``, in four modes
(``rules.moe_collectives``): ``xla`` (``torch.distributed``'s own
all-to-all), ``dragonfly`` and ``dragonfly_overlap`` (the §3 program on
``torch_dist``, in round and in ``start_step`` order) and
``dragonfly_overlap_fused`` (dispatch, expert FFN and combine as one wave
pipeline). Its semantics differ from the sparse path's, as in the
reference: ``C_loc = max(8, int(cf·T_loc·k/E))`` rounded up to 8, and the
combine accumulates in the activation dtype. ``moe_apply_ep_plain`` is its
one-process counterpart, for checks. ``moe_collectives="auto"`` asks the
autotuner (``runtime.autotune``) for one of the four at the top of each
call, before any exchange, keyed as the reference keys it; every rank of
the mesh gets the same mode.

The tensor-parallel path ``moe_apply_tp`` (experts replicated, each rank
holding its slice of every expert's ff dim) routes the rank's whole data
shard with the same capacity rule and sums the partial outputs over the
model axis with one ``all_reduce``; ``moe_apply_tp_plain`` is its
one-process counterpart. ``moe_apply_auto`` takes EP or TP as the
reference's launcher does.

The guest-embedded helpers (``moe_guest_dispatch``, ``moe_guest_combine``,
``guest_expert_ffn``) serve the multi-tenant fleet (``serve.fleet``): the
routing runs host-side in NumPy around a program replay, as in the
reference, and the expert FFN runs at each chunk's destination.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.autograd.profiler import record_function

from repro_torch.dist import sharding as SH
from repro_torch.models import layers as L

#: Where ``moe_apply_sparse`` appends each call's routing while
#: ``recording_routes`` is open: (top-k expert ids (T, k), kept (T·k,),
#: router logits (T, E)).
_ROUTES: list | None = None


@contextlib.contextmanager
def recording_routes():
    """Collect the routing of every ``moe_apply_sparse`` call made inside
    the block, in call order (one entry per MoE layer of a forward). A
    tool for forwards without autograd: a backward run inside the block
    through remat'd layers (``forward_train(..., remat=True)``) recomputes
    them and records each MoE layer again."""
    global _ROUTES
    outer, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = outer


def moe_init(gen, cfg, dtype, device):
    m = cfg.moe
    d = cfg.d_model
    s_in = d ** -0.5
    s_out = m.d_ff_expert ** -0.5
    E, ff = m.num_experts, m.d_ff_expert
    p = {
        "router": L.truncated_normal(gen, (d, E), dtype, s_in, device),
        "w_in": L.truncated_normal(gen, (E, d, ff), dtype, s_in, device),
        "w_gate": L.truncated_normal(gen, (E, d, ff), dtype, s_in, device),
        "w_out": L.truncated_normal(gen, (E, ff, d), dtype, s_out, device),
    }
    if m.shared_experts:
        p["shared"] = L.mlp_init(gen, d, ff * m.shared_experts, dtype, device)
    return p


def router_topk(logits: torch.Tensor, k: int, norm_probs: bool):
    """logits: (..., E) -> (weights (..., k) float32, indices (..., k) int64).
    Ties go to the lower expert index, as in ``jax.lax.top_k``."""
    probs = torch.softmax(logits.float(), dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[..., :k], idx[..., :k]
    if norm_probs:  # mixtral/deepseek renormalize the selected gates
        w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    return w, idx


def load_balance_loss(logits, idx, E, k):
    """Switch-style aux loss: E · Σ_e f_e · p_e."""
    probs = torch.softmax(logits.float(), dim=-1)
    p_mean = probs.mean(dim=0)
    f = F.one_hot(idx, E).float().sum(dim=(0, 1)) / (idx.shape[0] * k)
    return E * torch.sum(f * p_mean)


def _expert_ffn(params, h):
    """(E, C, d) expert-major tokens through each expert's gated FFN."""
    gate = torch.bmm(h, params["w_gate"])
    return torch.bmm(F.silu(gate) * torch.bmm(h, params["w_in"]), params["w_out"])


def moe_apply(params, x, cfg):
    """Dense dispatch: every expert sees every token, weighted by one-hot
    combine weights. Exact top-k (no capacity drops), O(T·E) memory: the
    reference semantics of the sparse path."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    logits = xt @ params["router"]
    w, idx = router_topk(logits, m.top_k, m.norm_topk_probs)
    # combine[t, e] = sum_k w[t,k] * [idx[t,k] == e]
    onehot = F.one_hot(idx, m.num_experts).float()  # (T, k, E)
    combine = (onehot * w[..., None]).sum(dim=1)  # (T, E)
    y_e = _expert_ffn(params, xt.expand(m.num_experts, T, d))  # (E, T, d)
    y = torch.einsum("etd,te->td", y_e.float(), combine).to(x.dtype)
    if "shared" in params:
        y = y + L.mlp_apply(params["shared"], xt)
    aux = load_balance_loss(logits, idx, m.num_experts, m.top_k)
    return y.reshape(B, S, d), aux


class _Routes(NamedTuple):
    logits: torch.Tensor  # (T, E)
    w: torch.Tensor       # (T, k) float32 gates
    idx: torch.Tensor     # (T, k) expert ids
    flat_e: torch.Tensor  # (T·k,)
    at: torch.Tensor      # (T·k,) slot, clipped to C - 1
    keep: torch.Tensor    # (T·k,) slot < C
    src: torch.Tensor     # (T·k,) token of each entry


def _route(xt, router, cfg, C: int) -> _Routes:
    """Route one token shard: top-k experts, each (token, k) entry's slot
    (its running count in its expert over the flattened (t, k) order) and
    whether it fits in ``C`` slots."""
    m = cfg.moe
    logits = xt @ router
    w, idx = router_topk(logits, m.top_k, m.norm_topk_probs)
    flat_e = idx.reshape(-1)
    # the running count, scanned along the last dim (a scan along dim 0 of
    # (T*k, E) took 3.1 ms a layer on an H100 at T*k = 16384)
    onehot = F.one_hot(flat_e, m.num_experts).T.contiguous()  # (E, T*k)
    slot = onehot.cumsum(dim=1).gather(0, flat_e[None])[0] - 1
    src = torch.arange(xt.shape[0], device=xt.device).repeat_interleave(m.top_k)
    return _Routes(logits, w, idx, flat_e, slot.clamp(0, C - 1), slot < C, src)


def _dispatch(xt, r: _Routes, E: int, C: int) -> torch.Tensor:
    """(E, C, d) expert-major buffer; dropped entries add zeros at slot C - 1."""
    buf = torch.zeros((E, C, xt.shape[1]), dtype=xt.dtype, device=xt.device)
    buf.index_put_((r.flat_e, r.at), torch.where(r.keep[:, None], xt[r.src], 0),
                   accumulate=True)
    return buf


def capacity(cfg, tokens: int, capacity_factor: float | None = None) -> int:
    """Slots per expert of the sparse dispatch for ``tokens`` tokens."""
    m = cfg.moe
    cf = m.capacity_factor if capacity_factor is None else capacity_factor
    C = max(1, int(cf * tokens * m.top_k / m.num_experts))
    return -(-C // 16) * 16


def moe_apply_sparse(params, x, cfg, capacity_factor: float | None = None):
    """Capacity-bounded sparse dispatch: tokens gather into per-expert
    buffers of ``capacity`` slots, and overflow drops (Switch/Mixtral
    style). The capacity couples every token of the call. Its three parts
    run under the profiler labels ``moe.dispatch`` (router and dispatch),
    ``moe.experts`` and ``moe.combine``."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E = m.num_experts
    C = capacity(cfg, T, capacity_factor)
    xt = x.reshape(T, d)
    with record_function("moe.dispatch"):
        r = _route(xt, params["router"], cfg, C)
        if _ROUTES is not None:
            _ROUTES.append((r.idx.detach(), r.keep.detach(), r.logits.detach()))
        buf = _dispatch(xt, r, E, C)
    with record_function("moe.experts"):
        y_buf = _expert_ffn(params, buf)  # (E, C, d)
    with record_function("moe.combine"):
        gathered = y_buf[r.flat_e, r.at].float() * r.w.reshape(-1)[:, None]
        y = torch.zeros((T, d), dtype=torch.float32, device=x.device)
        y.index_add_(0, r.src, torch.where(r.keep[:, None], gathered, 0))
        y = y.to(x.dtype)
    if "shared" in params:
        y = y + L.mlp_apply(params["shared"], xt)
    aux = load_balance_loss(r.logits, r.idx, E, m.top_k)
    return y.reshape(B, S, d), aux


#: the fixed exchange strategies of ``moe_apply_ep`` (``rules.moe_collectives``)
EP_MODES = ("xla", "dragonfly", "dragonfly_overlap", "dragonfly_overlap_fused")

#: Where ``moe_apply_ep`` adds each call's part times while ``timing_parts``
#: is open.
_PARTS: dict | None = None


@contextlib.contextmanager
def timing_parts():
    """Time the parts of every ``moe_apply_ep`` call made inside the block,
    summed over calls: ``exchange_ms``, the host ms of the dispatch and
    combine exchanges with their carrier copies (the device synchronised
    at each end; in the fused mode the round trip less its expert FFN),
    ``experts_ms``, the expert FFN's ms (CUDA events on the card, the host
    clock on the CPU), and ``gather_ms``, the host ms of the output
    all-gather; ``moe_apply_tp`` adds ``allreduce_ms``, the host ms of its
    partial outputs' all-reduce with the carrier copies, and its
    ``experts_ms``. Synchronising changes the run: time other calls
    without it."""
    global _PARTS
    outer, _PARTS = _PARTS, {"calls": 0, "exchange_ms": 0.0, "experts_ms": 0.0,
                             "gather_ms": 0.0, "allreduce_ms": 0.0}
    try:
        yield _PARTS
    finally:
        _PARTS = outer


class _Timer:
    """Host ms of a block with the device synchronised at both ends, or the
    device ms between two CUDA events (``events=True`` on the card)."""

    def __init__(self, device: torch.device, events: bool = False):
        self.device, self.ms = device, 0.0
        self.events = events and device.type == "cuda"

    def __enter__(self):
        if _PARTS is not None:
            if self.events:
                self.start = torch.cuda.Event(enable_timing=True)
                self.start.record()
            else:
                self._sync()
                self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if _PARTS is not None:
            if self.events:
                stop = torch.cuda.Event(enable_timing=True)
                stop.record()
                stop.synchronize()
                self.ms += self.start.elapsed_time(stop)
            else:
                self._sync()
                self.ms += (time.perf_counter() - self.t0) * 1e3

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def ep_capacity(cfg, tokens: int) -> int:
    """Slots per expert of one token shard of ``tokens`` tokens on the
    expert-parallel and tensor-parallel paths: at least 8, rounded up to a
    multiple of 8. EP's shard is a rank's B·S/n_model tokens, TP's the
    rank's whole data shard."""
    m = cfg.moe
    C = max(8, int(m.capacity_factor * tokens * m.top_k / m.num_experts))
    return -(-C // 8) * 8


def _combine(back, r: _Routes, T: int) -> torch.Tensor:
    """(T, d) from the returned (E, C, d) buffer, accumulated in its dtype
    with each gate cast to it, as the reference's ``out.at[src].add``."""
    g = back[r.flat_e, r.at]
    out = torch.zeros((T, back.shape[-1]), dtype=back.dtype, device=back.device)
    out.index_add_(0, r.src, torch.where(r.keep[:, None],
                                         g * r.w.reshape(-1)[:, None].to(g.dtype), 0))
    return out


def _check_ep_mode(mode: str) -> None:
    if mode not in EP_MODES + ("auto",):
        raise ValueError(f"unknown moe_collectives {mode!r}; expected one of "
                         f"{EP_MODES + ('auto',)}")


#: the dim of each expert stack that the TP-experts rule shards
EXPERT_FF_DIM = {"w_in": 2, "w_gate": 2, "w_out": 1}


def local_experts(params, rules, coords, sizes):
    """A MoE layer's parameters with ``w_in``, ``w_gate`` and ``w_out`` cut,
    as views, to the rows ``rules.expert`` gives the rank at ``coords`` of
    a mesh of ``sizes``; the router and the shared expert as given."""
    E = params["router"].shape[1]
    return {key: w[SH.local_slices(rules.expert(w.shape, EXPERT_FF_DIM[key], E), w.shape,
                                   coords, sizes)] if key in EXPERT_FF_DIM else w
            for key, w in params.items()}


def ep_auto_mode(cfg, T_loc: int, dtype, mesh, group) -> str:
    """The fixed mode the autotuner picks for ``moe_apply_ep``'s exchanges:
    the dispatch/combine all-to-all over the model axis' D3 view, keyed on
    the per-destination buffer bytes at the capacity bound and the expert
    FFN's ``moe_compute_us``, as the reference keys it. Measured on the
    model-axis ``group`` (its buffers on the mesh's carrier) and agreed by
    every rank of the mesh (the world: ``make_mesh`` lays the world out);
    the memo makes later calls a lookup."""
    from repro_torch.runtime import autotune

    m = cfg.moe
    n_model = dist.get_world_size(group)
    E_loc = m.num_experts // n_model
    c_loc = ep_capacity(cfg, T_loc)
    chunk = E_loc * c_loc * cfg.d_model * torch.empty((), dtype=dtype).element_size()
    dec = autotune.get_autotuner(mesh.device).decide(
        "alltoall", autotune.layout_for(n_model), chunk, dtype=dtype, site="shard",
        compute_us=autotune.moe_compute_us(E_loc, c_loc, n_model, cfg.d_model, m.d_ff_expert),
        group=group, carrier=mesh.carrier, agree_over=dist.group.WORLD)
    return autotune.EP_MODE[dec.strategy]


def moe_apply_ep(params, x, cfg):
    """Expert-parallel MoE on one rank of the active mesh: the dispatch and
    combine are explicit all-to-alls over the model axis, the §3 boundary.

    The per-rank form of the reference's ``shard_map``: ``x`` (B, S, d) is
    this rank's data shard, the same on every rank of its model group. The
    rank routes its T_loc = B·S/n_model contiguous tokens (its model
    coordinate's block, data-major as ``PS((data, model))`` gives), sends
    an (n_model, E_loc, C_loc, d) buffer to the experts' owners, runs its
    own E_loc experts on the (E_loc, n_model·C_loc, d) arrivals, returns
    the outputs, combines them, and all-gathers the tokens over its model
    group. Returns (y (B, S, d), aux): aux is the mean of every rank's
    load-balance loss, the reference's ``pmean``. Expert weights come
    whole (E, ...) or cut to this rank's (E_loc, ...) by ``rules.expert``.
    The shared expert, if any, runs on the data shard outside the exchange.

    Exchanges travel on the mesh's carrier device (the host for gloo, the
    card for NCCL), moved there and back explicitly and counted by the
    mesh; the expert products run on the rank's device. In the fused mode
    the compute takes each wave's arrivals to the device once.

    ``moe_collectives="auto"`` resolves to a fixed mode first
    (``ep_auto_mode``), on every rank of the mesh together."""
    from repro_torch.dist.collectives import (dragonfly_all_to_all,
                                              dragonfly_all_to_all_compute, native_all_to_all)
    from repro_torch.dist.mesh import dragonfly_layout
    from repro_torch.runtime.backends.torch_dist import TorchDistBackend

    act = SH.active()
    if act is None:
        raise RuntimeError("moe_apply_ep needs active sharding rules: dist.sharding.set_active")
    rules, mesh = act
    mode = rules.moe_collectives
    _check_ep_mode(mode)
    m = cfg.moe
    E, n_model = m.num_experts, rules.model_axis_size
    E_loc = E // n_model
    B, S, d = x.shape
    if E % n_model or (B * S) % n_model:
        raise ValueError(f"{E} experts and {B * S} tokens must split over {n_model} model ranks")
    T_loc = B * S // n_model
    mc = mesh.coords[rules.tensor_axis]
    xs = x.reshape(B * S, d)
    xt = xs[mc * T_loc:(mc + 1) * T_loc]
    held = params["w_in"].shape[0]
    if held == E and E_loc != E:
        experts = local_experts(params, rules, mesh.coords, mesh.sizes)
    elif held == E_loc:
        experts = params
    else:
        raise ValueError(f"the expert stacks hold {held} experts: expected all {E} or this "
                         f"rank's {E_loc}")
    C = ep_capacity(cfg, T_loc)
    group = mesh.group(rules.tensor_axis)
    layout = dragonfly_layout(n_model)
    if mode == "auto":
        mode = ep_auto_mode(cfg, T_loc, x.dtype, mesh, group)
    with record_function("moe.dispatch"):
        r = _route(xt, params["router"], cfg, C)
        if _ROUTES is not None:
            _ROUTES.append((r.idx.detach(), r.keep.detach(), r.logits.detach()))
        buf = _dispatch(xt, r, E, C).reshape(n_model, E_loc, C, d)
    ffn = _Timer(x.device, events=True)
    exchange = _Timer(x.device)
    if mode == "dragonfly_overlap_fused":
        def expert_chunk(chunks):
            # one wave's (V, E_loc, C, d) arrivals, on the carrier: to the
            # device once, the same gated FFN, and back
            h = mesh.from_carrier(chunks)
            V = h.shape[0]
            with ffn, record_function("moe.experts"):
                y = _expert_ffn(experts, h.transpose(0, 1).reshape(E_loc, V * C, d))
            return mesh.to_carrier(y.reshape(E_loc, V, C, d).transpose(0, 1))

        with exchange, record_function("moe.exchange"):
            back = mesh.from_carrier(dragonfly_all_to_all_compute(
                mesh.to_carrier(buf), group, layout, expert_chunk,
                backend=TorchDistBackend(overlap_fused=True)))
        exchange.ms -= ffn.ms
    else:
        if mode == "xla":
            def a2a(t):
                return native_all_to_all(t, group)
        else:
            be = TorchDistBackend(overlap=mode == "dragonfly_overlap")

            def a2a(t):
                return dragonfly_all_to_all(t, group, layout, backend=be)

        with exchange, record_function("moe.exchange"):
            recv = mesh.from_carrier(a2a(mesh.to_carrier(buf)))
        with ffn, record_function("moe.experts"):
            h = recv.transpose(0, 1).reshape(E_loc, n_model * C, d)
            y = _expert_ffn(experts, h).reshape(E_loc, n_model, C, d).transpose(0, 1)
        with exchange, record_function("moe.exchange"):
            back = mesh.from_carrier(a2a(mesh.to_carrier(y.contiguous())))
    with record_function("moe.combine"):
        out = _combine(back.reshape(E, C, d), r, T_loc)
        aux = load_balance_loss(r.logits, r.idx, E, m.top_k)
    gather = _Timer(x.device)
    with gather, record_function("moe.gather"):
        part = mesh.to_carrier(out)
        outs = [torch.empty_like(part) for _ in range(n_model)]
        dist.all_gather(outs, part, group=group)
        y = mesh.from_carrier(torch.cat(outs))
        total = mesh.to_carrier(aux.reshape(1)).clone()
        dist.all_reduce(total)  # over the whole mesh: every token shard
    if _PARTS is not None:
        _PARTS["calls"] += 1
        _PARTS["exchange_ms"] += exchange.ms
        _PARTS["experts_ms"] += ffn.ms
        _PARTS["gather_ms"] += gather.ms
    aux = mesh.from_carrier(total)[0] / math.prod(mesh.shape)
    if "shared" in params:
        y = y + L.mlp_apply(params["shared"], xs)
    return y.reshape(B, S, d), aux


def moe_apply_ep_plain(params, x, cfg, n_data: int, n_model: int):
    """The expert-parallel layer in one process, for checks: ``x`` is the
    whole (B, S, d) batch and the weights whole. Each of the
    n_data·n_model token shards routes with its own C_loc; each data
    group's shards meet at the experts as (E, n_model·C_loc, d), as the
    ranks' arrivals do; the combine runs in the activation dtype; aux is
    the mean of the per-shard losses. Nothing on the main path calls it."""
    m = cfg.moe
    E = m.num_experts
    B, S, d = x.shape
    n = n_data * n_model
    if E % n_model or (B * S) % n:
        raise ValueError(f"{E} experts and {B * S} tokens must split over a "
                         f"({n_data}, {n_model}) mesh")
    T_loc = B * S // n
    C = ep_capacity(cfg, T_loc)
    xt = x.reshape(B * S, d)
    shards = [xt[i * T_loc:(i + 1) * T_loc] for i in range(n)]
    routes = [_route(s, params["router"], cfg, C) for s in shards]
    if _ROUTES is not None:
        _ROUTES.append(tuple(torch.cat([getattr(r, key).detach() for r in routes])
                             for key in ("idx", "keep", "logits")))
    bufs = torch.stack([_dispatch(s, r, E, C) for s, r in zip(shards, routes)])
    h = bufs.reshape(n_data, n_model, E, C, d).transpose(1, 2).reshape(n_data, E, n_model * C, d)
    y = torch.stack([_expert_ffn(params, h[g]) for g in range(n_data)])
    y = y.reshape(n_data, E, n_model, C, d).transpose(1, 2).reshape(n, E, C, d)
    out = torch.cat([_combine(y[i], r, T_loc) for i, r in enumerate(routes)])
    aux = torch.stack([load_balance_loss(r.logits, r.idx, E, m.top_k) for r in routes]).mean()
    if "shared" in params:
        out = out + L.mlp_apply(params["shared"], xt)
    return out.reshape(B, S, d), aux


def _batch_mean(value: torch.Tensor, rules, mesh) -> torch.Tensor:
    """The mean of a scalar over the batch axes (the reference's ``pmean``
    over ``rules.batch_axes``): summed over each batch axis' group in
    turn, on the carrier."""
    axes = rules.batch_axes if isinstance(rules.batch_axes, tuple) else (rules.batch_axes,)
    total = mesh.to_carrier(value.reshape(1)).clone()
    n = 1
    for axis in axes:
        if mesh.sizes.get(axis, 1) > 1:
            dist.all_reduce(total, group=mesh.group(axis))
            n *= mesh.sizes[axis]
    return mesh.from_carrier(total)[0] / n


def _ff_slice(params, n_model: int, j: int) -> dict:
    """Expert stacks cut to model shard ``j`` of ``n_model`` along the ff
    dim (``EXPERT_FF_DIM``), as views."""
    out = {}
    for key, w in params.items():
        if key in EXPERT_FF_DIM:
            dim = EXPERT_FF_DIM[key]
            f = w.shape[dim] // n_model
            w = w.narrow(dim, j * f, f)
        out[key] = w
    return out


def moe_apply_tp(params, x, cfg):
    """Tensor-parallel MoE on one rank of the active mesh, for E that the
    model axis does not divide (Mixtral's 8 experts on a 16-wide axis).

    The per-rank form of the reference's ``shard_map``: ``x`` (B, S, d) is
    this rank's data shard, the same on every rank of its model group.
    Experts are replicated and each rank holds the slice of every expert's
    ff dim at its model coordinate (what ``rules.expert`` gives where E
    does not split over the model axis); the expert stacks come whole
    (cut here, as views) or already cut. The dispatch is local: the rank
    routes its whole data shard with ``C_loc = ep_capacity(cfg, B·S)``,
    runs its ff slice of every expert, and the one collective is the
    ``all_reduce`` (sum) of the partial outputs over the model axis, in
    their dtype, on the mesh's carrier. Returns (y (B, S, d), aux): aux is
    the mean of the data shards' load-balance losses, the reference's
    ``pmean`` over the batch axes. The shared expert, if any, runs on the
    data shard outside the collective.

    gloo sums in an order of its own, not in rank order: the output is
    ``moe_apply_tp_plain``'s bit for bit when that sums in the order
    ``ObservedSumOrder`` reads off the same group."""
    act = SH.active()
    if act is None:
        raise RuntimeError("moe_apply_tp needs active sharding rules: dist.sharding.set_active")
    rules, mesh = act
    m = cfg.moe
    E, n_model = m.num_experts, rules.model_axis_size
    B, S, d = x.shape
    T_loc = B * S
    ff = m.d_ff_expert
    held = params["w_in"].shape[EXPERT_FF_DIM["w_in"]]
    if ff % n_model:
        raise ValueError(f"the experts' ff dim {ff} does not split over {n_model} model ranks")
    if held == ff and n_model > 1:
        experts = _ff_slice(params, n_model, mesh.coords[rules.tensor_axis])
    elif held == ff // n_model:
        experts = params
    else:
        raise ValueError(f"the expert stacks hold an ff dim of {held}: expected all {ff} or "
                         f"this rank's {ff // n_model}")
    xt = x.reshape(T_loc, d)
    C = ep_capacity(cfg, T_loc)
    with record_function("moe.dispatch"):
        r = _route(xt, params["router"], cfg, C)
        if _ROUTES is not None:
            _ROUTES.append((r.idx.detach(), r.keep.detach(), r.logits.detach()))
        buf = _dispatch(xt, r, E, C)
    ffn = _Timer(x.device, events=True)
    with ffn, record_function("moe.experts"):
        y_part = _expert_ffn(experts, buf).to(xt.dtype)  # partial over the ff shards
    reduce = _Timer(x.device)
    with reduce, record_function("moe.allreduce"):
        y_buf = mesh.to_carrier(y_part)  # y_part is this call's own: summed in place
        dist.all_reduce(y_buf, group=mesh.group(rules.tensor_axis))
        y_buf = mesh.from_carrier(y_buf)
    with record_function("moe.combine"):
        out = _combine(y_buf, r, T_loc)
        aux = _batch_mean(load_balance_loss(r.logits, r.idx, E, m.top_k), rules, mesh)
    if _PARTS is not None:
        _PARTS["calls"] += 1
        _PARTS["experts_ms"] += ffn.ms
        _PARTS["allreduce_ms"] += reduce.ms
    y = out
    if "shared" in params:
        y = y + L.mlp_apply(params["shared"], xt)
    return y.reshape(B, S, d), aux


def _rank_order_sum(parts):
    y = parts[0]
    for p in parts[1:]:
        y = y + p
    return y


def moe_apply_tp_plain(params, x, cfg, n_data: int, n_model: int, reduce=None):
    """The tensor-parallel layer in one process, for checks: ``x`` is the
    whole (B, S, d) batch and the weights whole. Each of the n_data data
    shards routes with its own C_loc; each of the n_model ff shards of
    every expert computes its partial output, and ``reduce`` sums a data
    shard's list of n_model partials (by default in rank order, in their
    dtype; a check may pass the all-reduce's own order); the combine runs
    in the activation dtype; aux is the mean of the data shards' losses.
    Nothing on the main path calls it."""
    m = cfg.moe
    E = m.num_experts
    B, S, d = x.shape
    if (B * S) % n_data or m.d_ff_expert % n_model:
        raise ValueError(f"{B * S} tokens and an ff dim of {m.d_ff_expert} must split over a "
                         f"({n_data}, {n_model}) mesh")
    T_loc = B * S // n_data
    C = ep_capacity(cfg, T_loc)
    xt = x.reshape(B * S, d)
    shards = [xt[i * T_loc:(i + 1) * T_loc] for i in range(n_data)]
    routes = [_route(s, params["router"], cfg, C) for s in shards]
    if _ROUTES is not None:
        _ROUTES.append(tuple(torch.cat([getattr(r, key).detach() for r in routes])
                             for key in ("idx", "keep", "logits")))
    outs = []
    for s, r in zip(shards, routes):
        buf = _dispatch(s, r, E, C)
        parts = [_expert_ffn(_ff_slice(params, n_model, j), buf).to(s.dtype)
                 for j in range(n_model)]
        outs.append(_combine((reduce or _rank_order_sum)(parts), r, T_loc))
    out = torch.cat(outs)
    aux = torch.stack([load_balance_loss(r.logits, r.idx, E, m.top_k) for r in routes]).mean()
    if "shared" in params:
        out = out + L.mlp_apply(params["shared"], xt)
    return out.reshape(B, S, d), aux


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def _ring_sum(parts, start: int, step: int):
    """((p_start + p_start±1) + ...) over all n parts, in their dtype."""
    n = len(parts)
    acc = parts[start]
    for i in range(1, n):
        acc = acc + parts[(start + step * i) % n]
    return acc


class ObservedSumOrder:
    """The order in which an all-reduce summed each element, read off
    observed calls, as a ``reduce`` for ``moe_apply_tp_plain``: gloo sums
    in an order of its own, so its result is the rank-order sum only up
    to rounding, and a check that wants the bits needs this order.

    ``calls`` yields ``(inputs, got)`` of each observed call: the n ranks'
    inputs and the output, all of one shape and dtype (those of the calls
    to be matched: a ring all-reduce's order depends on the size alone).
    Each element is matched against the 2n ring orders (start at rank s,
    walk up or down the ranks) and keeps those that every call matches;
    several calls of random data leave one order for nearly every element
    (one call of bf16 normals over 16 ranks leaves one for 6 % of them,
    eight for 99.8 %). An element that more orders still match than the
    fewest any element does takes the order of the nearest settled
    element before it, or else of the nearest after it. Raises where an element matches no ring
    order, or neither of its neighbours'. ``runs`` lists (first element,
    (start, step)) of each run of one order; calling it on n parts of
    that shape sums each element in its order."""

    def __init__(self, calls):
        mask = orders = None
        for inputs, got in calls:
            n = len(inputs)
            want = _bits(got.reshape(-1))
            if mask is None:
                orders = [(s, step) for step in (1, -1) for s in range(n)]
                mask = torch.full((want.numel(),), (1 << len(orders)) - 1, dtype=torch.int64,
                                  device=got.device)
                self.shape = got.shape
            hit = torch.zeros_like(mask)
            for c, (s, step) in enumerate(orders):
                hit |= (_bits(_ring_sum(inputs, s, step).reshape(-1)) == want).long() << c
            mask &= hit
        if not bool((mask != 0).all()):
            raise ValueError(f"{int((mask == 0).sum())} of {mask.numel()} elements match no "
                             f"ring order of {len(orders) // 2} ranks")
        # settled: matched by as few orders as any element is (one from 4
        # ranks on; with fewer, some orders always sum alike)
        count = sum((mask >> c) & 1 for c in range(len(orders)))
        unique = count == count.min()
        first = torch.nonzero(unique)[:, 0]
        chain = torch.zeros_like(mask)  # the lowest order each element matches
        for c in reversed(range(len(orders))):
            chain = torch.where((mask >> c) & 1 == 1, c, chain)
        idx = torch.arange(mask.numel(), device=mask.device)
        before = torch.cummax(torch.where(unique, idx, -1), 0).values
        after = torch.cummin(torch.where(unique, idx, mask.numel()).flip(0), 0).values.flip(0)
        later = chain[torch.where(after == mask.numel(), first[-1], after)]
        chain = chain[torch.where(before < 0, first[0], before)]
        chain = torch.where((mask >> chain) & 1 == 1, chain, later)
        if not bool(((mask >> chain) & 1).all()):
            raise ValueError("the all-reduce did not sum in runs of one ring order")
        starts = torch.nonzero(torch.diff(chain, prepend=chain[:1] - 1)).reshape(-1).tolist()
        self.runs = [(i, orders[int(chain[i])]) for i in starts]
        self.unique_share = float(unique.float().mean())
        self._chain = chain.reshape(self.shape)
        self._orders = orders

    @staticmethod
    def inputs(call: int, n: int, shape, dtype, device, rank=None):
        """Call ``call``'s inputs: normals from seed 1000·call + rank, the
        n ranks' list (or rank ``rank``'s one)."""
        def one(r):
            gen = torch.Generator(device=device).manual_seed(1000 * call + r)
            return torch.randn(shape, generator=gen, device=device).to(dtype)

        return one(rank) if rank is not None else [one(r) for r in range(n)]

    @classmethod
    def observe(cls, mesh, axis: str, shape, dtype, calls: int):
        """On every rank of ``axis``' group: ``calls`` all-reduces of
        ``inputs``, on the mesh's carrier; returns their outputs (host
        tensors, the same on every rank)."""
        n, rank = mesh.sizes[axis], mesh.coords[axis]
        out = []
        for call in range(calls):
            t = mesh.to_carrier(cls.inputs(call, n, shape, dtype, mesh.device, rank))
            dist.all_reduce(t, group=mesh.group(axis))
            out.append(t.cpu())
        return out

    @classmethod
    def read(cls, outputs, n: int, device):
        """The order of ``observe``'s calls on n ranks, read on ``device``."""
        return cls((cls.inputs(call, n, o.shape, o.dtype, device), o.to(device))
                   for call, o in enumerate(outputs))

    def __call__(self, parts):
        if parts[0].shape != self.shape:
            raise ValueError(f"the order was read at {tuple(self.shape)}, not "
                             f"{tuple(parts[0].shape)}")
        chain = self._chain.to(parts[0].device)
        out = torch.empty_like(parts[0])
        for c in sorted({o for _, o in self.runs}, key=self._orders.index):
            sel = chain == self._orders.index(c)
            out = torch.where(sel, _ring_sum(parts, *c), out)
        return out


def moe_apply_auto(params, x, cfg):
    """The MoE FFN as the reference's launcher would pick it. With sharding
    rules active (``dist.sharding.set_active``) ``x`` is this rank's data
    shard: the expert-parallel path runs where the model axis divides the
    experts and the shard's tokens, and the tensor-parallel path where it
    does not divide the experts (the reference also asks that the global
    token count split over the data axis, which a data shard always
    does). Otherwise, and with no rules active (one card), the sparse
    dispatch runs, on the rank's data shard: with one data shard that is
    the reference's sparse path under rules; with more, its capacity
    counts only the shard's tokens."""
    act = SH.active()
    if act is not None:
        rules = act[0]
        T = x.shape[0] * x.shape[1]
        if rules.expert_parallel(cfg.moe.num_experts):
            if T % rules.model_axis_size == 0:
                return moe_apply_ep(params, x, cfg)
        else:
            return moe_apply_tp(params, x, cfg)
    return moe_apply_sparse(params, x, cfg)


# ---------------------------------------------------------------------------
# Guest-embedded dispatch: the whole-array §3 form for multi-tenant serving.
#
# A tenant admitted as a D3(J,L) guest on a D3(K,M) host routes its expert
# dispatch and combine through a program replay instead of a collective of
# its own: ``moe_guest_dispatch`` packs the batch's capacity buffers into an
# (n_guest, n_guest, E_loc, C, d) §3 dispatch array (every token sourced at
# guest device 0, the expert shards spread over all guest devices), a
# backend's ``run_alltoall_compute`` round trip computes each chunk's expert
# FFN at its destination (``guest_expert_ffn``), and ``moe_guest_combine``
# gathers the returned buffers back per token. The routing (top-k, running
# capacity slots, overflow drops) is the reference's NumPy, line for line:
# it runs on the host around the replay, which carries N tenants at once
# through one combined host program (serve/fleet.py).
# ---------------------------------------------------------------------------


def guest_capacity(m, T: int) -> int:
    """Per-expert capacity for T routed tokens: the ``moe_apply_sparse``
    bound (cf·T·k/E, rounded up to a multiple of 16)."""
    C = max(1, int(m.capacity_factor * T * m.top_k / m.num_experts))
    return -(-C // 16) * 16


def _np32(a) -> np.ndarray:
    """A tensor (any device and dtype) or an array as a float32 NumPy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def _np_softmax(v: np.ndarray) -> np.ndarray:
    v = v - v.max(axis=-1, keepdims=True)
    e = np.exp(v)
    return e / e.sum(axis=-1, keepdims=True)


def _np_silu(v: np.ndarray) -> np.ndarray:
    # x·sigmoid(x) through tanh: stable for both signs, no exp overflow
    return v * (0.5 * (1.0 + np.tanh(0.5 * v)))


@dataclasses.dataclass
class GuestDispatchState:
    """Everything ``moe_guest_combine`` needs to invert a dispatch: the
    router weights and capacity slot of each (token, k) entry, and the
    shapes to unflatten back to."""

    w: np.ndarray        # (T, top_k) router weights
    flat_e: np.ndarray   # (T·top_k,) expert of each entry
    slot: np.ndarray     # (T·top_k,) capacity slot within the expert's buffer
    keep: np.ndarray     # (T·top_k,) False: dropped by the capacity bound
    src: np.ndarray      # (T·top_k,) source token
    shape: tuple         # (B, S, d) of the dispatched activations
    C: int
    E_loc: int


def moe_guest_dispatch(params, x, cfg, n_guest: int):
    """Route (B, S, d) activations into the whole-array guest dispatch form.

    Returns ``(X, state)``: X is (n_guest, n_guest, E_loc, C, d) float32
    with X[0, j] the capacity chunks bound for guest device j's experts
    (every token lives on guest device 0: a decode batch is one data
    shard) and zeros elsewhere. A ``run_alltoall_compute`` round trip
    gives back[0, j] = FFN_j(X[0, j]), which ``moe_guest_combine`` takes.
    Needs E % n_guest == 0 (each guest device owns E/n_guest experts).
    ``params`` and ``x`` may be tensors on any device or arrays."""
    m = cfg.moe
    x = _np32(x)
    B, S, d = x.shape
    T = B * S
    E = m.num_experts
    if E % n_guest:
        raise ValueError(f"E={E} experts do not shard over {n_guest} guest devices")
    E_loc = E // n_guest
    C = guest_capacity(m, T)
    xt = x.reshape(T, d)
    logits = xt @ _np32(params["router"])
    probs = _np_softmax(logits)
    # a stable argsort of -probs takes the lower expert on ties, as lax.top_k
    idx = np.argsort(-probs, axis=-1, kind="stable")[:, : m.top_k]
    w = np.take_along_axis(probs, idx, axis=-1)
    if m.norm_topk_probs:
        w = w / np.clip(w.sum(-1, keepdims=True), 1e-9, None)
    flat_e = idx.reshape(-1)
    onehot = np.eye(E, dtype=np.int64)[flat_e]
    slot = ((np.cumsum(onehot, axis=0) - 1) * onehot).sum(-1)
    keep = slot < C
    src = np.repeat(np.arange(T), m.top_k)
    buf = np.zeros((E, C, d), np.float32)
    # (expert, slot) pairs are unique (slot is the running count in the
    # expert), so this is a plain scatter, not an accumulation
    buf[flat_e[keep], slot[keep]] = xt[src[keep]]
    X = np.zeros((n_guest, n_guest, E_loc, C, d), np.float32)
    X[0] = buf.reshape(n_guest, E_loc, C, d)
    state = GuestDispatchState(w=w, flat_e=flat_e, slot=slot, keep=keep, src=src,
                               shape=(B, S, d), C=C, E_loc=E_loc)
    return X, state


def moe_guest_combine(back, state: GuestDispatchState, params, x):
    """Invert ``moe_guest_dispatch``: gather each token's expert outputs
    from the returned (n_guest, n_guest, E_loc, C, d) round-trip array
    (rows back[0, :]), weight them by the gates and add the shared expert
    (``layers.mlp_apply`` on ``x`` as float32, on the device of its
    weights). Returns (B, S, d) float32 NumPy."""
    B, S, d = state.shape
    T = B * S
    y_buf = _np32(back)[0].reshape(-1, state.C, d)  # (E, C, d)
    y = np.zeros((T, d), np.float32)
    g = y_buf[state.flat_e[state.keep], state.slot[state.keep]]
    np.add.at(y, state.src[state.keep], g * state.w.reshape(-1)[state.keep, None])
    if "shared" in params:
        shared = params["shared"]
        where = next(iter(shared.values()))
        where = where.device if isinstance(where, torch.Tensor) else torch.device("cpu")
        xt = torch.from_numpy(_np32(x).reshape(T, d)).to(where)
        shared = {key: torch.as_tensor(w, device=where).float() for key, w in shared.items()}
        y = y + _np32(L.mlp_apply(shared, xt))
    return y.reshape(B, S, d)


def guest_expert_shards(params, n_guest: int):
    """Each guest device's expert shards as float32 NumPy arrays: (w_in,
    w_gate) each (n_guest, E_loc, d, f) and w_out (n_guest, E_loc, f, d);
    row g is what guest device g's ``guest_expert_ffn_np`` takes. A host
    copy of every expert: the NumPy replay's, never the card's."""
    E = params["w_in"].shape[0]
    if E % n_guest:
        raise ValueError(f"E={E} does not shard over {n_guest} guest devices")

    def shard(a):
        a = _np32(a)
        return a.reshape(n_guest, E // n_guest, *a.shape[1:])

    return shard(params["w_in"]), shard(params["w_gate"]), shard(params["w_out"])


def guest_experts(params, n_guest: int, g: int):
    """Guest device ``g``'s (w_in, w_gate, w_out): its E/n_guest experts,
    as views of the stacks where they lie."""
    E = params["w_in"].shape[0]
    if E % n_guest:
        raise ValueError(f"E={E} does not shard over {n_guest} guest devices")
    E_loc = E // n_guest
    return tuple(params[key][g * E_loc:(g + 1) * E_loc] for key in ("w_in", "w_gate", "w_out"))


def guest_expert_ffn_np(chunks, w_in, w_gate, w_out):
    """One device's silu-gated expert FFN over arriving capacity chunks: the
    NumPy replay's compute. ``chunks`` (..., E_loc, C, d) with this
    device's (E_loc, d, f) / (E_loc, f, d) shards; batched over any leading
    dims (a replay hands over the whole stack of arrivals at once)."""
    h = _np_silu(np.einsum("...ecd,edf->...ecf", chunks, w_gate)) * np.einsum(
        "...ecd,edf->...ecf", chunks, w_in)
    return np.einsum("...ecf,efd->...ecd", h, w_out)


def guest_expert_ffn(chunks, w_in, w_gate, w_out):
    """``guest_expert_ffn_np`` in torch, in float32 as the reference
    computes it: the compute of a device-backed ``run_alltoall_compute``.
    Runs on the device of the weights, which are cast per call (bf16
    weights stay bf16 where they are stored); the chunks come back on
    their own device."""
    where = chunks.device
    h = chunks.to(w_in.device, torch.float32)
    w_in, w_gate, w_out = (w.float() for w in (w_in, w_gate, w_out))
    a = F.silu(torch.einsum("...ecd,edf->...ecf", h, w_gate)) * torch.einsum(
        "...ecd,edf->...ecf", h, w_in)
    return torch.einsum("...ecf,efd->...ecd", a, w_out).to(where)
