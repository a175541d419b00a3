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

The expert-parallel (``moe_apply_ep``), tensor-parallel (``moe_apply_tp``)
and guest-embedded modes wait for later slices: ``moe_apply_auto`` names
their ROADMAP items when a mesh would pick them.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.autograd.profiler import record_function

from repro_torch.models import layers as L

#: Where ``moe_apply_sparse`` appends each call's routing while
#: ``recording_routes`` is open: (top-k expert ids (T, k), kept (T·k,),
#: router logits (T, E)).
_ROUTES: list | None = None


@contextlib.contextmanager
def recording_routes():
    """Collect the routing of every ``moe_apply_sparse`` call made inside
    the block, in call order (one entry per MoE layer of a forward)."""
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
        logits = xt @ params["router"]
        w, idx = router_topk(logits, m.top_k, m.norm_topk_probs)  # (T, k)
        flat_e = idx.reshape(-1)  # (T*k,)
        # position of each (t, k) within its expert's buffer: the running
        # count, scanned along the last dim (a scan along dim 0 of (T*k, E)
        # took 3.1 ms a layer on an H100 at T*k = 16384)
        onehot = F.one_hot(flat_e, E).T.contiguous()  # (E, T*k) int64
        slot = onehot.cumsum(dim=1).gather(0, flat_e[None])[0] - 1
        keep = slot < C
        at = slot.clamp(0, C - 1)
        src_tok = torch.arange(T, device=x.device).repeat_interleave(m.top_k)
        if _ROUTES is not None:
            _ROUTES.append((idx.detach(), keep.detach(), logits.detach()))
        buf = torch.zeros((E, C, d), dtype=xt.dtype, device=x.device)
        buf.index_put_((flat_e, at), torch.where(keep[:, None], xt[src_tok], 0),
                       accumulate=True)
    with record_function("moe.experts"):
        y_buf = _expert_ffn(params, buf)  # (E, C, d)
    with record_function("moe.combine"):
        gathered = y_buf[flat_e, at].float() * w.reshape(-1)[:, None]
        y = torch.zeros((T, d), dtype=torch.float32, device=x.device)
        y.index_add_(0, src_tok, torch.where(keep[:, None], gathered, 0))
        y = y.to(x.dtype)
    if "shared" in params:
        y = y + L.mlp_apply(params["shared"], xt)
    aux = load_balance_loss(logits, idx, E, m.top_k)
    return y.reshape(B, S, d), aux


def moe_apply_auto(params, x, cfg, mesh: tuple[int, int] | None = None):
    """The MoE FFN as the reference's launcher would pick it. ``mesh`` is
    (data axis size, model axis size) of the devices the layer spreads
    over; with none (one card) the sparse dispatch runs. A mesh picks the
    expert-parallel path where the model axis divides the experts and the
    tensor-parallel path where it does not, each when the tokens split
    evenly over it (else the sparse dispatch, as in the reference); both
    wait for later slices."""
    if mesh is not None:
        n_data, n_model = mesh
        T = x.shape[0] * x.shape[1]
        if cfg.moe.num_experts % n_model == 0:
            if T % (n_model * n_data) == 0:
                raise NotImplementedError(
                    "the expert-parallel MoE (EP, models/moe.py: moe_apply_ep) is not ported "
                    "yet: ROADMAP Queue 1 item 1")
        elif T % n_data == 0:
            raise NotImplementedError(
                "the tensor-parallel MoE (TP, models/moe.py: moe_apply_tp) is not ported "
                "yet: ROADMAP Queue 1 item 2")
    return moe_apply_sparse(params, x, cfg)
