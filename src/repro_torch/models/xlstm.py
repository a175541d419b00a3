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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.profiler import record_function

from repro_torch.models import layers as L


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


def _mlstm_heads(params, xu, cfg):
    dp = xu.shape[-1]
    H = cfg.n_heads
    dh = dp // H
    xh = xu.reshape(*xu.shape[:-1], H, dh)
    q = torch.einsum("...hd,hde->...he", xh, params["wq"])
    k = torch.einsum("...hd,hde->...he", xh, params["wk"]) * (dh ** -0.5)
    v = torch.einsum("...hd,hde->...he", xh, params["wv"])
    i_pre, f_pre = (xu @ params["w_if"] + params["b_if"]).chunk(2, dim=-1)  # (..., H)
    return q, k, v, i_pre.float(), f_pre.float()


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


def mlstm_train(params, x, cfg, chunk: int = 256):
    """Parallel form up to ``chunk`` positions, chunkwise beyond."""
    with record_function("mixer.mlstm"):
        B, S, _ = x.shape
        xu, z = (x @ params["w_up"]).chunk(2, dim=-1)
        q, k, v, i_pre, f_pre = _mlstm_heads(params, xu, cfg)
        if S <= chunk:
            h = mlstm_parallel_inner(q, k, v, i_pre, f_pre)
        else:
            h = mlstm_chunked_inner(q, k, v, i_pre, f_pre, chunk)
        h = h.reshape(B, S, -1).to(x.dtype)
        h = L.rmsnorm(params["ogate_norm"], h) * F.silu(z)
        return h @ params["w_down"]


def mlstm_decode(params, x, state, cfg):
    """state: {'C': (B, H, dh, dh), 'n': (B, H, dh), 'm': (B, H)}. Returns
    (out (B, 1, d), new state); the state is not changed in place."""
    B = x.shape[0]
    xu, z = (x[:, 0] @ params["w_up"]).chunk(2, dim=-1)
    q, k, v, i_pre, f_pre = _mlstm_heads(params, xu, cfg)
    logf = F.logsigmoid(f_pre)  # (B, H)
    m_new = torch.maximum(logf + state["m"], i_pre)
    fw = torch.exp(logf + state["m"] - m_new)[..., None]
    iw = torch.exp(i_pre - m_new)[..., None]
    kf, vf, qf = k.float(), v.float(), q.float()
    C = state["C"].float() * fw[..., None] + iw[..., None] * (kf[..., :, None] * vf[..., None, :])
    n = state["n"].float() * fw + iw * kf
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    den = torch.einsum("bhd,bhd->bh", qf, n).abs() + torch.exp(-m_new)
    h = (num / torch.clamp(den, min=1.0)[..., None]).reshape(B, -1).to(x.dtype)
    h = L.rmsnorm(params["ogate_norm"], h) * F.silu(z)
    out = (h @ params["w_down"])[:, None]
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


def _slstm_step(params, carry, gx):
    """carry: (c, n, h, m), each (B, d) float32; gx: (B, 4d), the input's
    gate projection ``x_t @ w_gates``."""
    c, n, h, m = carry
    gates = (gx + h.to(gx.dtype) @ params["r_gates"] + params["b_gates"]).float()
    i_pre, f_pre, z_pre, o_pre = gates.chunk(4, dim=-1)
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + m, i_pre)
    iw = torch.exp(i_pre - m_new)
    fw = torch.exp(logf + m - m_new)
    c_new = fw * c + iw * torch.tanh(z_pre)
    n_new = fw * n + iw
    h_new = torch.sigmoid(o_pre) * c_new / torch.clamp(n_new, min=1.0)
    return c_new, n_new, h_new, m_new


def slstm_train(params, x, cfg):
    """A loop over S; the input projections of every position in one product."""
    with record_function("mixer.slstm"):
        B, S, d = x.shape
        gx = x @ params["w_gates"]  # (B, S, 4d)
        carry = tuple(torch.zeros((B, d), dtype=torch.float32, device=x.device)
                      for _ in range(4))
        hs = torch.empty((B, S, d), dtype=x.dtype, device=x.device)
        for t in range(S):
            carry = _slstm_step(params, carry, gx[:, t])
            hs[:, t] = carry[2]
        return hs @ params["w_out"]


def slstm_decode(params, x, state, cfg):
    c, n, h, m = _slstm_step(params, (state["c"], state["n"], state["h"], state["m"]),
                             x[:, 0] @ params["w_gates"])
    out = (h.to(x.dtype) @ params["w_out"])[:, None]
    return out, {"c": c, "n": n, "h": h, "m": m}


def slstm_state_init(cfg, batch, dtype, device):
    d = cfg.d_model
    return {key: torch.zeros((batch, d), dtype=torch.float32, device=device)
            for key in ("c", "n", "h", "m")}
