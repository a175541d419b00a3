"""Mamba (S6 selective SSM) block — Jamba's recurrent layer.

The port of ``repro.models.mamba``. Training runs the selective scan in a
chunked form (``selective_scan``): the sequence goes through in blocks of
at most ``BLOCK_TOKENS`` tokens (batch rows times positions), a block's
chunks of ``CHUNK`` positions scan side by side step by step from a zero
state, and the float32 state ``h (B, di, N)`` then carries from chunk to
chunk through the chunk's cumulative decay. The JAX package scans with
``jax.lax.associative_scan`` over the whole sequence at once, holding
(B, S, di, N) float32 tensors (1 MiB a token at Jamba's width); this form
holds a block's, and sums in another order, so it agrees with the
reference to a tolerance, not to the bit. Under autograd the same scan
runs as a ``torch.autograd.Function`` whose backward recomputes each
block from its saved entering state and scans the adjoint back through
it, so training holds a block's float32 terms, not the sequence's.
``selective_scan_plain`` is the step-by-step recurrence of the decode
form, the oracle both are held to.
Decode is the O(1) single-step update of the conv window and SSM state.

The discretisation ``exp(dt·A)`` and ``dt·x·B`` is computed in float32 and
``y`` is cast to the compute dtype before ``* silu(z)``, as in the JAX
package. The mixer runs under the profiler label ``mixer.mamba``, its scan
under ``mamba.scan``. Sharding specs are not ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.autograd.profiler import record_function

from repro_torch.models import layers as L

#: Positions of one chunk, scanned step by step.
CHUNK = 32
#: Tokens (batch rows times positions) of one block of side-by-side chunks:
#: bounds the float32 (B, T, di, N) tensors a block holds (512 MiB each at
#: Jamba's width).
BLOCK_TOKENS = 512
#: Tokens of one block of the training form (``_SelectiveScan``): its
#: backward holds about four of a block's (B, T, di, N) float32 tensors
#: (128 MiB each at Jamba's width).
TRAIN_BLOCK_TOKENS = 128


def mamba_init(gen, cfg, dtype, device):
    d = cfg.d_model
    m = cfg.mamba
    di = m.expand * d
    s = d ** -0.5

    def tn(shape, scale):
        return L.truncated_normal(gen, shape, dtype, scale, device)

    p = {"w_in": tn((d, 2 * di), s),  # x and z
         "conv_w": tn((m.d_conv, di), m.d_conv ** -0.5),
         "conv_b": torch.zeros((di,), dtype=dtype, device=device),
         "w_bcdt": tn((di, 2 * m.d_state + m.dt_rank), di ** -0.5),
         "w_dt": tn((m.dt_rank, di), m.dt_rank ** -0.5)}
    u = torch.empty((di,), dtype=torch.float32, device=device).uniform_(
        math.log(0.001), math.log(0.1), generator=gen)
    p["dt_bias"] = torch.log(torch.expm1(torch.exp(u))).to(dtype)
    p["A_log"] = torch.log(torch.arange(1, m.d_state + 1, dtype=torch.float32, device=device)
                           ).repeat(di, 1).to(dtype)
    p["D"] = torch.ones((di,), dtype=dtype, device=device)
    p["w_out"] = tn((di, d), di ** -0.5)
    return p


def _mm(a, w):
    """``a @ w`` in the wider of the two dtypes, as JAX promotes (a float32
    decode state times bf16 weights is a float32 product)."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def _ssm_params(params, xc, m):
    """xc: (..., di) conv output -> dt (..., di), B, C (..., d_state)."""
    bcdt = _mm(xc, params["w_bcdt"])
    Bm, Cm, dt_in = torch.split(bcdt, [m.d_state, m.d_state, m.dt_rank], dim=-1)
    dt = F.softplus(_mm(dt_in, params["w_dt"]) + params["dt_bias"])
    return dt, Bm, Cm


def scan_inputs(params, x, cfg):
    """The scan's inputs for x (B, S, d): the conv output ``xc`` and gate
    ``z`` (B, S, di), ``dt`` (B, S, di), ``Bm``, ``Cm`` (B, S, N) and
    ``A`` (di, N) in float32."""
    m = cfg.mamba
    S = x.shape[1]
    xi, z = (x @ params["w_in"]).chunk(2, dim=-1)  # (B, S, di)
    # depthwise causal conv1d: a sum of d_conv shifted products
    pad = F.pad(xi, (0, 0, m.d_conv - 1, 0))
    xc = sum(pad[:, i:i + S, :] * params["conv_w"][i] for i in range(m.d_conv)) + params["conv_b"]
    xc = F.silu(xc)
    dt, Bm, Cm = _ssm_params(params, xc, m)
    A = -torch.exp(params["A_log"].float())
    return xc, z, dt, Bm, Cm, A


def _discretize(dt, xc, Bm, A):
    """a = exp(dt·A) and b = dt·x·B, float32 (B, T, di, N) each."""
    a = torch.exp(dt.float()[..., None] * A)
    bx = (dt * xc).float()[..., None] * Bm.float()[..., None, :]
    return a, bx


def _scan_block(a, bx, h, chunk):
    """h_t = a_t·h_{t-1} + b_t over a block of T = n·chunk positions, the
    n chunks side by side: each chunk scans step by step from a zero state
    (chunk 0 from ``h``), then chunk c adds the running product of its
    decays times the last state of chunk c - 1. Returns (B, T, di, N)."""
    Bsz, T = a.shape[:2]
    n = T // chunk
    a = a.view(Bsz, n, chunk, *a.shape[2:])
    bx = bx.view(Bsz, n, chunk, *bx.shape[2:])
    hs = torch.empty_like(bx)
    run = torch.zeros_like(bx[:, :, 0])
    run[:, 0] = h
    for t in range(chunk):
        run = torch.addcmul(bx[:, :, t], a[:, :, t], run, out=hs[:, :, t])
    for c in range(1, n):
        hs[:, c].addcmul_(torch.cumprod(a[:, c], dim=1), hs[:, c - 1, -1:])
    return hs.view(Bsz, T, *hs.shape[3:])


def _spans(Bsz, S, block_tokens):
    """(lo, hi, chunk) of each block: at most ``block_tokens`` tokens, cut
    into whole chunks of ``CHUNK`` positions and a shorter tail."""
    chunk = CHUNK
    per_block = max(chunk, block_tokens // Bsz // chunk * chunk)
    for lo in range(0, S, per_block):
        hi = min(lo + per_block, S)
        whole = lo + (hi - lo) // chunk * chunk
        for a0, a1, c in ((lo, whole, chunk), (whole, hi, hi - whole)):
            if a1 > a0:
                yield a0, a1, c


def _block_terms(dtf, dx, Bmf, a0, a1, A):
    """a = exp(dt·A) and b = (dt·x)·B of positions [a0, a1), float32
    (B, T, di, N) each (``_discretize`` on float32 inputs)."""
    return torch.exp(dtf[:, a0:a1, :, None] * A), dx[:, a0:a1, :, None] * Bmf[:, a0:a1, None, :]


def _scan_forward(dtf, dx, Bmf, Cmf, A, block_tokens, states=None):
    """y (B, S, di) of the chunked scan on float32 inputs; appends each
    block's entering state to ``states`` when given."""
    Bsz, S, di = dtf.shape
    h = torch.zeros((Bsz, di, A.shape[1]), dtype=torch.float32, device=dtf.device)
    ys = []
    for a0, a1, c in _spans(Bsz, S, block_tokens):
        if states is not None:
            states.append(h)
        a, bx = _block_terms(dtf, dx, Bmf, a0, a1, A)
        hs = _scan_block(a, bx, h, c)
        del a, bx
        h = hs[:, -1].clone()
        ys.append((hs @ Cmf[:, a0:a1, :, None])[..., 0])
        del hs
    return torch.cat(ys, dim=1)


def _scan_block_back(a, lam, carry, chunk):
    """The adjoint of ``_scan_block``, in place: ``lam`` holds dL/dy's
    share u_t = gy_t·C_t on entry and λ_t = u_t + a_{t+1}·λ_{t+1} on exit,
    λ at the block's last position also taking ``carry`` (dL/dh there from
    later blocks). The n chunks run side by side backwards from a zero
    adjoint (the last from ``carry``), then chunk c adds the running
    product of the decays after each position times chunk c + 1's
    first λ, from the last chunk down."""
    Bsz, T = a.shape[:2]
    n = T // chunk
    a = a.view(Bsz, n, chunk, *a.shape[2:])
    lam = lam.view(Bsz, n, chunk, *lam.shape[2:])
    run = torch.zeros_like(lam[:, :, 0])
    run[:, -1] = carry
    for t in reversed(range(chunk)):
        run = lam[:, :, t].add_(run) if t == chunk - 1 else \
            torch.addcmul(lam[:, :, t], a[:, :, t + 1], run, out=lam[:, :, t])
    for c in range(n - 2, -1, -1):
        after = torch.cumprod(a[:, c, 1:].flip(1), dim=1).flip(1)  # Π a_{t+1..chunk-1}
        edge = a[:, c + 1, 0] * lam[:, c + 1, 0]
        lam[:, c, :-1].addcmul_(after, edge[:, None])
        lam[:, c, -1].add_(edge)


class _SelectiveScan(torch.autograd.Function):
    """The chunked scan with a backward of its own, in blocks of
    ``TRAIN_BLOCK_TOKENS``: the forward keeps only each block's entering
    state (B, di, N); the backward walks the blocks in reverse, recomputes
    a block's a, b and states from its entering state, and scans the
    adjoint back through it (``_scan_block_back``). A block's few
    (B, T, di, N) float32 terms are all it holds at once."""

    @staticmethod
    def forward(ctx, dtf, dx, Bmf, Cmf, A):
        states = []
        y = _scan_forward(dtf, dx, Bmf, Cmf, A, TRAIN_BLOCK_TOKENS, states)
        ctx.save_for_backward(dtf, dx, Bmf, Cmf, A, *states)
        return y

    @staticmethod
    def backward(ctx, gy):
        dtf, dx, Bmf, Cmf, A, *states = ctx.saved_tensors
        Bsz, S, di = dtf.shape
        g_dt, g_dx = torch.empty_like(dtf), torch.empty_like(dx)
        g_B, g_C, g_A = torch.empty_like(Bmf), torch.empty_like(Cmf), torch.zeros_like(A)
        gy = gy.float()
        carry = torch.zeros_like(states[0])  # dL/dh at the block's last position, from later
        spans = list(_spans(Bsz, S, TRAIN_BLOCK_TOKENS))
        for (a0, a1, c), h0 in zip(reversed(spans), reversed(states)):
            a, bx = _block_terms(dtf, dx, Bmf, a0, a1, A)
            hs = _scan_block(a, bx, h0, c)
            del bx
            g_C[:, a0:a1] = torch.einsum("btdn,btd->btn", hs, gy[:, a0:a1])
            lam = gy[:, a0:a1, :, None] * Cmf[:, a0:a1, None, :]
            _scan_block_back(a, lam, carry, c)
            carry = a[:, 0] * lam[:, 0]
            g_dx[:, a0:a1] = torch.einsum("btdn,btn->btd", lam, Bmf[:, a0:a1])
            g_B[:, a0:a1] = torch.einsum("btdn,btd->btn", lam, dx[:, a0:a1])
            ga = a.mul_(lam)  # dL/d(dt·A) = λ_t·h_{t-1}·a_t, built in a's buffer
            del lam
            ga[:, 1:].mul_(hs[:, :-1])
            ga[:, 0].mul_(h0)
            del hs
            g_dt[:, a0:a1] = (ga * A).sum(-1)
            g_A += torch.einsum("btdn,btd->dn", ga, dtf[:, a0:a1])
            del ga, a
        return g_dt, g_dx, g_B, g_C, g_A


def selective_scan(dt, xc, Bm, Cm, A):
    """y_t = Σ_N h_t·C_t with h_t = exp(dt_t·A)·h_{t-1} + dt_t·x_t·B_t from
    h = 0: (B, S, di) float32. Blocks of at most ``BLOCK_TOKENS`` tokens,
    each cut into whole chunks of ``CHUNK`` positions and a shorter tail.
    Where autograd records and an input needs a gradient, the training
    form (``_SelectiveScan``) runs the same scan with its own backward:
    the serving form's in-place writes are not differentiable."""
    dtf, dx, Bmf, Cmf = dt.float(), (dt * xc).float(), Bm.float(), Cm.float()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (dt, xc, Bm, Cm, A)):
        return _SelectiveScan.apply(dtf, dx, Bmf, Cmf, A)
    return _scan_forward(dtf, dx, Bmf, Cmf, A, BLOCK_TOKENS)


def selective_scan_plain(dt, xc, Bm, Cm, A):
    """The same recurrence one position at a time, as ``mamba_decode``
    steps it: the oracle of ``selective_scan``."""
    Bsz, S, di = xc.shape
    h = torch.zeros((Bsz, di, A.shape[1]), dtype=torch.float32, device=xc.device)
    ys = []
    for t in range(S):
        a, bx = _discretize(dt[:, t], xc[:, t], Bm[:, t], A)
        h = a * h + bx
        ys.append((h * Cm[:, t].float()[:, None, :]).sum(-1))
    return torch.stack(ys, dim=1)


def _out(params, y, xc, z, dtype):
    """D skip, the gate and the out projection."""
    y = y + params["D"].float() * xc.float()
    return (y.to(dtype) * F.silu(z)) @ params["w_out"]


def mamba_train(params, x, cfg):
    """x: (B, S, d) -> (B, S, d). Chunked scan over S."""
    with record_function("mixer.mamba"):
        xc, z, dt, Bm, Cm, A = scan_inputs(params, x, cfg)
        with record_function("mamba.scan"):
            y = selective_scan(dt, xc, Bm, Cm, A)
        return _out(params, y, xc, z, x.dtype)


def mamba_decode(params, x, state, cfg):
    """x: (B, 1, d); state: {'conv': (B, d_conv-1, di), 'ssm': (B, di, N)}.
    Returns (out (B, 1, d), new state); the state is not changed in place."""
    m = cfg.mamba
    xi, z = (x[:, 0] @ params["w_in"]).chunk(2, dim=-1)  # (B, di)
    conv = state["conv"]
    window = torch.cat([conv, xi[:, None].to(torch.promote_types(conv.dtype, xi.dtype))], dim=1)
    xc = F.silu((window * params["conv_w"][None]).sum(1) + params["conv_b"])
    dt, Bm, Cm = _ssm_params(params, xc, m)
    A = -torch.exp(params["A_log"].float())
    a, bx = _discretize(dt, xc, Bm, A)  # (B, di, N)
    h = a * state["ssm"].float() + bx
    y = (h * Cm.float()[:, None, :]).sum(-1)
    out = _out(params, y, xc, z, x.dtype)[:, None]
    return out, {"conv": window[:, 1:], "ssm": h.to(state["ssm"].dtype)}


def mamba_state_init(cfg, batch, dtype, device):
    m = cfg.mamba
    di = m.expand * cfg.d_model
    return {"conv": torch.zeros((batch, m.d_conv - 1, di), dtype=dtype, device=device),
            "ssm": torch.zeros((batch, di, m.d_state), dtype=dtype, device=device)}
