"""xLSTM blocks (Beck et al. 2024): mLSTM (matrix memory, attention-like
parallel form) and sLSTM (scalar memory, sequential scan).

The port of ``repro.models.xlstm``. xlstm-1.3b uses an [m:s] interleave
(7 mLSTM : 1 sLSTM per group of 8). The mLSTM trains in its quadratic
stabilised parallel form up to ``chunk`` positions and in the chunkwise
form beyond, a Python loop over chunks carrying (C, n, m); the sLSTM is a
Python loop over positions. Decode is O(1): mLSTM carries (C, n, m) per
head, sLSTM (c, n, h, m). The stabilisers ``m`` and every sLSTM state are
float32, and the products of the inner forms run in float32, as in the
JAX package (in float64 for float64 operands: the oracle of the chunkwise
form is the parallel form in float64). The mixers run under the profiler labels ``mixer.mlstm`` and
``mixer.slstm``. ``mlstm_specs`` and ``slstm_specs`` give each parameter's
sharding spec as a plain tuple.

Under the tensor axis (``tp``: the train and decode paths under active
rules) both mixers run on the rank's leaves as their specs cut them, on
channel block c of m, and move activations, never weights (but the
sLSTM's ``r_gates`` below). Without one they run the same bodies on
``TensorParallel.one_process()``, where every collective is the identity
and every leaf whole.

mLSTM: ``w_up`` (d, 2·dp) is ``[x | gate]`` cut contiguously, so a rank
holds x columns or gate columns only. A head's dh channels may span
several ranks (xLSTM-1.3B: 4 heads of 1024 on 16 ranks), and the
chunkwise form needs a head's q and k whole, so the rank computes every
head its dp block touches (a head on several ranks is computed on each)
with the replicated block-diagonal ``wq``, ``wk``, ``wv`` and keeps its
block's columns. Each rank multiplies by its stored columns and one
all-to-all of those products (``TensorParallel.fetch``) gives it the x
columns of the heads it computes and its block of the gate: B·S·(dh·h +
dp / m) values, h the heads it touches (1,280 of the 8,192 columns at
xLSTM-1.3B's 4 heads on 16 ranks). ``w_if`` is a row block: the (…, 2H)
i and f pre-activations are its partial products summed over the axis.
``ogate_norm``, an RMS norm over the whole dp, sums the float32 sum of
squares of the rank's block over the axis (``layers.rmsnorm`` with
``tp``). ``w_down`` is a row block. The decode state ``C`` (B, H, dh, dh)
and ``n`` (B, H, dh) are the rank's block of every head's key dim, ``m``
(B, H) whole (``cache_specs``): the fetch gives the rank the new token's
x columns of every head, it updates its rows of C and n from its key
columns of k (q and k from its columns of ``wq`` and ``wk``, v whole),
and q·C and q·n, partial over the key dim, are summed over the axis in
one float32 sum, after which h is whole on every rank and its norm
needs no sum.

sLSTM: ``w_gates``, ``r_gates`` and ``b_gates`` are ``[i | f | z | o]``
(4·d) cut contiguously, so a quarter of the ranks holds each gate. The
rank's d / m channels (the state specs' (b, t) block) take their own i,
f, z and o: in the train form the input projection of every position is
one product of the stored columns and one all-to-all of those
activations (``TensorParallel.own_parts``), and ``r_gates`` and
``b_gates`` are exchanged so once a forward (d·4·d / m values a rank),
the recurrence then running on the rank's channels with one all-gather
of ``h`` (B, d / m) a position; in the decode the stored columns' gate
pre-activations x·W + h·R + b are exchanged, one all-to-all and one
all-gather of the previous ``h`` a step. ``c``, ``n``, ``h`` and ``m``
stay at their shards; ``w_out`` is a row block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.profiler import record_function

from repro_torch.dist.collectives import TensorParallel
from repro_torch.models import layers as L
from repro_torch.models.attention import head_block


# ---------------------------------------------------------------- mLSTM
def mlstm_init(gen, cfg, dtype, device):
    d = cfg.d_model
    H = cfg.n_heads
    dp = int(cfg.xlstm.proj_factor_mlstm * d)
    dh = dp // H

    def tn(shape, scale):
        return L.truncated_normal(gen, shape, dtype, scale, device)

    # q/k/v are BLOCK-DIAGONAL per head (the xLSTM paper's BlockLinear):
    # (H, dh, dh) instead of (dp, dp), 1/H the parameters and products.
    return {
        "w_up": tn((d, 2 * dp), d ** -0.5),  # x and gate
        "wq": tn((H, dh, dh), dh ** -0.5),
        "wk": tn((H, dh, dh), dh ** -0.5),
        "wv": tn((H, dh, dh), dh ** -0.5),
        "w_if": tn((dp, 2 * H), dp ** -0.5),
        "b_if": torch.zeros((2 * H,), dtype=dtype, device=device),
        "ogate_norm": L.rmsnorm_init(dp, dtype, device),
        "w_down": tn((dp, d), dp ** -0.5),
    }


def mlstm_specs(cfg, rules):
    t = rules.tensor_axis
    return {
        "w_up": (None, t),
        # block-diagonal per-head weights: the head count (4) is below the
        # tensor axis' size, so these stay replicated
        "wq": (None, None, None),
        "wk": (None, None, None),
        "wv": (None, None, None),
        "w_if": (t, None),
        "b_if": (None,),
        "ogate_norm": {"scale": (None,)},
        "w_down": (t, None),
    }


def _block(n: int, tp) -> tuple[int, int]:
    """The rank's block [lo, hi) of a dim of ``n`` cut evenly over the axis."""
    return tp.coord * n // tp.size, (tp.coord + 1) * n // tp.size


def _mlstm_heads(params, xu, heads, keys, block, tp):
    """q, k, v (..., h1 - h0, ·) and the float32 i and f pre-activations
    (..., h1 - h0) of heads [h0, h1) = ``heads`` from their x columns
    ``xu`` (..., (h1 - h0)·dh); q and k on key columns [k0, k1) = ``keys``.
    i and f are the rank's rows ``w_if`` against its dp block [lo, hi) =
    ``block`` of xu, in float32 (the stabiliser they feed is float32) and
    summed over the axis."""
    (h0, h1), (k0, k1), (lo, hi) = heads, keys, block
    dh = params["wq"].shape[-1]
    xh = xu.reshape(*xu.shape[:-1], h1 - h0, dh)
    q = torch.einsum("...hd,hde->...he", xh, params["wq"][h0:h1, :, k0:k1])
    k = torch.einsum("...hd,hde->...he", xh, params["wk"][h0:h1, :, k0:k1]) * (dh ** -0.5)
    v = torch.einsum("...hd,hde->...he", xh, params["wv"][h0:h1])
    part = xu[..., lo - h0 * dh:hi - h0 * dh].float() @ params["w_if"].float()
    i_pre, f_pre = (tp.sum(part) + params["b_if"].float()).chunk(2, dim=-1)  # (..., H)
    return q, k, v, i_pre[..., h0:h1], f_pre[..., h0:h1]


def _causal(n, device):
    return torch.ones((n, n), dtype=torch.bool, device=device).tril()


def _acc(t):
    """The inner forms' products run in float32, or in float64 for float64
    operands (an oracle)."""
    return torch.promote_types(t.dtype, torch.float32)


def mlstm_parallel_inner(q, k, v, i_pre, f_pre):
    """Quadratic stabilised parallel form: the oracle, and the whole
    sequence up to ``chunk`` positions. Shapes (B, S, H, ·)."""
    S, acc = q.shape[1], _acc(q)
    logf = F.logsigmoid(f_pre)  # (B, S, H)
    Fc = torch.cumsum(logf, dim=1)
    Dmat = Fc[:, :, None, :] - Fc[:, None, :, :] + i_pre[:, None, :, :]  # (B, S, S, H)
    Dmat = Dmat.masked_fill(~_causal(S, q.device)[None, :, :, None], float("-inf"))
    m_state = Dmat.amax(dim=2)  # (B, S, H)
    Dw = torch.exp(Dmat - m_state[:, :, None, :])
    scores = torch.einsum("bthd,bshd->btsh", q.to(acc), k.to(acc))
    w = scores * Dw
    denom = w.sum(2).abs() + torch.exp(-m_state)  # (B, S, H)
    hnum = torch.einsum("btsh,bshd->bthd", w, v.to(acc))
    return hnum / torch.clamp(denom, min=1.0)[..., None]


def mlstm_chunked_inner(q, k, v, i_pre, f_pre, chunk: int):
    """Chunkwise-parallel mLSTM (xLSTM's training form): a loop over chunks
    carrying the recurrent (C, n, m) state, quadratic only within a chunk
    (score tiles (B, c, c, H) instead of (B, S, S, H)). Equals the parallel
    form up to the stabiliser, a per-chunk-prefix running max."""
    B, S, H, dh = q.shape
    assert S % chunk == 0, (S, chunk)
    dev, acc = q.device, _acc(q)
    C = torch.zeros((B, H, dh, dh), dtype=acc, device=dev)
    n = torch.zeros((B, H, dh), dtype=acc, device=dev)
    m = torch.zeros((B, H), dtype=acc, device=dev)
    mask = _causal(chunk, dev)[None, :, :, None]
    hs = []
    for lo in range(0, S, chunk):
        sl = slice(lo, lo + chunk)
        qf, kf, vf = q[:, sl].to(acc), k[:, sl].to(acc), v[:, sl].to(acc)
        ii = i_pre[:, sl].to(acc)
        Fc = torch.cumsum(F.logsigmoid(f_pre[:, sl].to(acc)), dim=1)  # (B, c, H)
        Ftot = Fc[:, -1]  # (B, H)
        # stabiliser per row: max(carried m + F_t, the intra-chunk max)
        Dmat = (Fc[:, :, None, :] - Fc[:, None, :, :] + ii[:, None, :, :]).masked_fill(
            ~mask, float("-inf"))
        m_inter = m[:, None, :] + Fc  # (B, c, H)
        m_row = torch.maximum(Dmat.amax(dim=2), m_inter)
        Dw = torch.exp(Dmat - m_row[:, :, None, :])
        w = torch.einsum("bthd,bshd->btsh", qf, kf) * Dw
        intra_num = torch.einsum("btsh,bshd->bthd", w, vf)
        inter_w = torch.exp(m_inter - m_row)  # (B, c, H)
        inter_num = torch.einsum("bthd,bhde->bthe", qf, C) * inter_w[..., None]
        inter_den = torch.einsum("bthd,bhd->bth", qf, n) * inter_w
        den = (w.sum(2) + inter_den).abs() + torch.exp(-m_row)
        hs.append((intra_num + inter_num) / torch.clamp(den, min=1.0)[..., None])
        # the state at the chunk's end: the new stabiliser is the max of the
        # carried one decayed to the end and the chunk's keys' Ftot - F_s + i_s
        key_log = Ftot[:, None] - Fc + ii  # (B, c, H)
        m_new = torch.maximum(m + Ftot, key_log.amax(dim=1))
        kw = torch.exp(key_log - m_new[:, None])
        decay = torch.exp(m + Ftot - m_new)
        C = C * decay[..., None, None] + torch.einsum("bshd,bshe,bsh->bhde", kf, vf, kw)
        n = n * decay[..., None] + torch.einsum("bshd,bsh->bhd", kf, kw)
        m = m_new
    return torch.cat(hs, dim=1)


def _inner(q, k, v, i_pre, f_pre, chunk):
    if q.shape[1] <= chunk:
        return mlstm_parallel_inner(q, k, v, i_pre, f_pre)
    return mlstm_chunked_inner(q, k, v, i_pre, f_pre, chunk)


def mlstm_expect_cuts(params, cfg, tp) -> None:
    """Raise ``ValueError`` naming the first leaf that is not the rank's cut
    on the tensor axis (``mlstm_specs``)."""
    dp = int(cfg.xlstm.proj_factor_mlstm * cfg.d_model)
    for name, dim, whole in (("w_up", 1, 2 * dp), ("w_if", 0, dp), ("w_down", 0, dp)):
        L.expect_cut(name, params[name], dim, whole, tp)


def _up(params, x, dp, H, tp, every_head):
    """(xu, z): the x columns of the heads the rank computes (those its dp
    block touches, or with ``every_head`` all of them) and its block of
    the gate, fetched from the products of the stored ``[x | gate]``
    columns of ``w_up``."""
    dh, m = dp // H, tp.size

    def wants(c):
        h0, h1 = (0, H) if every_head else head_block(H, m, c)
        return (h0 * dh, h1 * dh), (dp + c * dp // m, dp + (c + 1) * dp // m)

    u = tp.fetch(x @ params["w_up"], tuple(wants(c) for c in range(m)))
    return u.split([u.shape[-1] - dp // m, dp // m], dim=-1)


def mlstm_train(params, x, cfg, chunk: int = 256, tp=None):
    """Parallel form up to ``chunk`` positions, chunkwise beyond. With
    ``tp`` on the rank's cut leaves and channel block (module docstring)."""
    with record_function("mixer.mlstm"):
        tp = tp or TensorParallel.one_process()
        mlstm_expect_cuts(params, cfg, tp)
        x = tp.col_in(x)
        B, S, _ = x.shape
        H, dp = cfg.n_heads, int(cfg.xlstm.proj_factor_mlstm * cfg.d_model)
        dh = dp // H
        xu, z = _up(params, x, dp, H, tp, False)
        (h0, h1), (lo, hi) = head_block(H, tp.size, tp.coord), _block(dp, tp)
        q, k, v, i_pre, f_pre = _mlstm_heads(params, xu, (h0, h1), (0, dh), (lo, hi), tp)
        h = _inner(q, k, v, i_pre, f_pre, chunk)
        h = h.reshape(B, S, -1)[..., lo - h0 * dh:hi - h0 * dh].to(x.dtype)
        h = L.rmsnorm(params["ogate_norm"], h, tp=tp) * F.silu(z)
        return tp.row_out(h @ params["w_down"])


def mlstm_decode(params, x, state, cfg, tp=None):
    """state: {'C': (B, H, dh, dh), 'n': (B, H, dh), 'm': (B, H)}. Returns
    (out (B, 1, d), new state); the state is not changed in place. With
    ``tp`` on the rank's cut leaves, ``C`` and ``n`` the rank's block of
    every head's key dim (module docstring), never gathered."""
    tp = tp or TensorParallel.one_process()
    mlstm_expect_cuts(params, cfg, tp)
    B, H, dp = x.shape[0], cfg.n_heads, int(cfg.xlstm.proj_factor_mlstm * cfg.d_model)
    L.expect_cut("C", state["C"], 2, dp // H, tp)
    xu, z = _up(params, x[:, 0], dp, H, tp, True)
    (lo, hi), keys = _block(dp, tp), _block(dp // H, tp)
    q, k, v, i_pre, f_pre = _mlstm_heads(params, xu, (0, H), keys, (lo, hi), tp)
    logf = F.logsigmoid(f_pre)  # (B, H)
    m_new = torch.maximum(logf + state["m"], i_pre)
    fw = torch.exp(logf + state["m"] - m_new)[..., None]
    iw = torch.exp(i_pre - m_new)[..., None]
    kf, vf, qf = k.float(), v.float(), q.float()
    C = state["C"].float() * fw[..., None] + iw[..., None] * (kf[..., :, None] * vf[..., None, :])
    n = state["n"].float() * fw + iw * kf
    # q·C and q·n are partial over the key dim: one float32 sum carries both
    both = tp.sum(torch.cat([torch.einsum("bhd,bhde->bhe", qf, C),
                             torch.einsum("bhd,bhd->bh", qf, n)[..., None]], dim=-1))
    num, den = both[..., :-1], both[..., -1].abs() + torch.exp(-m_new)
    h = (num / torch.clamp(den, min=1.0)[..., None]).reshape(B, -1).to(x.dtype)
    h = L.rmsnorm(params["ogate_norm"], h)[..., lo:hi] * F.silu(z)
    out = tp.row_out(h @ params["w_down"])[:, None]
    return out, {"C": C.to(state["C"].dtype), "n": n.to(state["n"].dtype), "m": m_new}


def mlstm_state_init(cfg, batch, dtype, device):
    H = cfg.n_heads
    dh = int(cfg.xlstm.proj_factor_mlstm * cfg.d_model) // H
    return {"C": torch.zeros((batch, H, dh, dh), dtype=dtype, device=device),
            "n": torch.zeros((batch, H, dh), dtype=dtype, device=device),
            "m": torch.zeros((batch, H), dtype=torch.float32, device=device)}


# ---------------------------------------------------------------- sLSTM
def slstm_init(gen, cfg, dtype, device):
    d = cfg.d_model
    s = d ** -0.5
    return {
        "w_gates": L.truncated_normal(gen, (d, 4 * d), dtype, s, device),  # i, f, z, o
        "r_gates": L.truncated_normal(gen, (d, 4 * d), dtype, s * 0.5, device),
        "b_gates": torch.zeros((4 * d,), dtype=dtype, device=device),
        "w_out": L.truncated_normal(gen, (d, d), dtype, s, device),
    }


def slstm_specs(cfg, rules):
    t = rules.tensor_axis
    return {
        "w_gates": (None, t),
        "r_gates": (None, t),
        "b_gates": (t,),
        "w_out": (t, None),
    }


def _slstm_cell(gates, c, n, m):
    """The new (c, n, h, m) from the float32 gate pre-activations ``[i | f |
    z | o]`` (B, 4·d) and the carried c, n, m (B, d)."""
    i_pre, f_pre, z_pre, o_pre = gates.chunk(4, dim=-1)
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + m, i_pre)
    iw = torch.exp(i_pre - m_new)
    fw = torch.exp(logf + m - m_new)
    c_new = fw * c + iw * torch.tanh(z_pre)
    n_new = fw * n + iw
    h_new = torch.sigmoid(o_pre) * c_new / torch.clamp(n_new, min=1.0)
    return c_new, n_new, h_new, m_new


def slstm_expect_cuts(params, cfg, tp) -> None:
    """Raise ``ValueError`` naming the first leaf that is not the rank's cut
    on the tensor axis (``slstm_specs``)."""
    d = cfg.d_model
    for name, dim, whole in (("w_gates", 1, 4 * d), ("r_gates", 1, 4 * d),
                             ("b_gates", 0, 4 * d), ("w_out", 0, d)):
        L.expect_cut(name, params[name], dim, whole, tp)


def slstm_train(params, x, cfg, tp=None):
    """A loop over S; the input projections of every position in one
    product. With ``tp`` on the rank's cut leaves and channels (module
    docstring)."""
    with record_function("mixer.slstm"):
        tp = tp or TensorParallel.one_process()
        slstm_expect_cuts(params, cfg, tp)
        x = tp.col_in(x)
        B, S, d = x.shape
        gx = tp.own_parts(x @ params["w_gates"], 4)  # (B, S, 4·d/m): the rank's i, f, z, o
        r, b = tp.own_parts(params["r_gates"], 4), tp.own_parts(params["b_gates"], 4)
        c, n, m = (torch.zeros((B, d // tp.size), dtype=torch.float32, device=x.device)
                   for _ in range(3))
        h = torch.zeros((B, d), dtype=gx.dtype, device=x.device)
        hs = []
        for t in range(S):
            c, n, h_own, m = _slstm_cell((gx[:, t] + h @ r + b).float(), c, n, m)
            h = tp.gather_last(h_own.to(gx.dtype))
            hs.append(h_own.to(x.dtype))
        return tp.row_out(torch.stack(hs, dim=1) @ params["w_out"])


def slstm_decode(params, x, state, cfg, tp=None):
    """One step. With ``tp`` on the rank's cut leaves, each state the rank's
    (B, d / m) channels (``cache_specs``), never gathered: the previous
    ``h`` gathered whole, the gate pre-activations of the rank's stored
    columns exchanged for its own channels' i, f, z and o."""
    tp = tp or TensorParallel.one_process()
    slstm_expect_cuts(params, cfg, tp)
    L.expect_cut("h", state["h"], 1, cfg.d_model, tp)
    gx = x[:, 0] @ params["w_gates"]
    h_prev = tp.gather_last(state["h"].to(gx.dtype))
    gates = tp.own_parts(gx + h_prev @ params["r_gates"] + params["b_gates"], 4).float()
    c, n, h, m = _slstm_cell(gates, state["c"], state["n"], state["m"])
    out = tp.row_out(h.to(x.dtype) @ params["w_out"])[:, None]
    return out, {"c": c, "n": n, "h": h, "m": m}


def slstm_state_init(cfg, batch, dtype, device):
    d = cfg.d_model
    return {key: torch.zeros((batch, d), dtype=torch.float32, device=device)
            for key in ("c", "n", "h", "m")}
