"""Attention variants: GQA (+ sliding window, + M-RoPE for Qwen2-VL) and
MLA (DeepSeek latent attention). Train path (full sequence, flash kernel)
and decode path (single token, KV or latent cache).

The port of ``repro.models.attention``, with the sharding specs
(``gqa_specs``, ``mla_specs``) as plain tuples. The decode paths write the new token into
the cache in place (the JAX package returns an updated copy) and return
the cache all the same.

Under the tensor axis (``tp``: the train path under active rules) the
train forms run on the rank's heads, as the reference's specs cut them:
``wq``, ``wk``, ``wv`` (MLA: ``wq_b``, ``wkv_b``) by columns, ``wo`` by
rows, the rank's block of the H·(head dim) columns being heads
[c·H/m, (c+1)·H/m) of H at coordinate c of m. Where the heads split over
the axis the rank computes its H/m query heads from its own columns.
Where the KV heads do not (TinyLlama's 4 and Mixtral's 8 on an axis of
16, the smoke configs' 2 on 4), ``wk`` and ``wv`` are gathered over the
axis and the rank takes the KV heads its query heads read (query head h
reads KV head h // (H / Hkv)). Where the query heads do not split either
(Qwen2-VL's 28 on 16, the smoke configs' 4 on 8), the column leaves are
gathered and the rank computes every head its block touches (a head cut
between two blocks is computed on both), and keeps its block's columns
of the output. The output projection's partial leaves through
``tp.row_out``. MLA's ``wq_a``, ``wkv_a`` and norms stay whole.

The decode forms under ``tp`` (the decode under active rules) hold each
cache as the rank's block of the sequence, as the reference's
``cache_specs`` cut it: positions [c·S_loc, (c+1)·S_loc) of the cache's
``m``·S_loc, never gathered. The new token's q, k and v (MLA: q) are the
rank's columns of the projections, gathered whole over the axis in one
all-gather (B·(H + 2·Hkv)·hd values); the rank that owns a row's position
writes its new key and value there, no other rank writes; every query
head attends over the rank's block, masked by global key positions, and
the ranks' float32 partials join by their log-sum-exp
(``dist.collectives.lse_combine``). The rank then takes its own heads'
columns of the output through its row-cut ``wo`` and a sum over the
axis. MLA expands its block of the latent cache through ``wkv_b``
gathered whole, every step, as the one-process form does.
"""

from __future__ import annotations

import torch
from torch.autograd.profiler import record_function

from repro_torch.dist import collectives as CL
from repro_torch.kernels.flash_attention.ops import gqa_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import layers as L


# =========================================================== GQA / SWA
def gqa_init(gen, cfg, dtype, device):
    d = cfg.d_model
    hd = cfg.head_dim
    s = d ** -0.5
    return {
        "wq": L.truncated_normal(gen, (d, cfg.n_heads * hd), dtype, s, device),
        "wk": L.truncated_normal(gen, (d, cfg.n_kv_heads * hd), dtype, s, device),
        "wv": L.truncated_normal(gen, (d, cfg.n_kv_heads * hd), dtype, s, device),
        "wo": L.truncated_normal(gen, (cfg.n_heads * hd, d), dtype,
                                 (cfg.n_heads * hd) ** -0.5, device),
    }


def gqa_specs(cfg, rules):
    return {
        "wq": rules.attn_in((0, 0)),
        "wk": rules.attn_in((0, 0)),
        "wv": rules.attn_in((0, 0)),
        "wo": rules.attn_out((0, 0)),
    }


def _project_qkv(params, x, cfg, positions, mrope_positions=None):
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = (x @ params["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (x @ params["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ params["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    q, k = _rotate_qk(q, k, cfg, positions, mrope_positions)
    return q, k, v


def _rotate_qk(q, k, cfg, positions, mrope_positions):
    if cfg.rope == "mrope":
        q = L.apply_mrope(q, mrope_positions, cfg.mrope_sections, cfg.rope_theta)
        k = L.apply_mrope(k, mrope_positions, cfg.mrope_sections, cfg.rope_theta)
    elif cfg.rope == "rope":
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k


def gqa_train(params, x, cfg, positions, mrope_positions=None, use_kernel=True, tp=None):
    """Causal (windowed) GQA over the sequence; with ``tp`` on the rank's
    heads (module docstring), ``x`` entering through ``tp.col_in``."""
    if tp is not None:
        return _gqa_train_tp(params, x, cfg, positions, mrope_positions, use_kernel, tp)
    q, k, v = _project_qkv(params, x, cfg, positions, mrope_positions)
    o = gqa_attention(q, k, v, causal=True, window=cfg.sliding_window, use_kernel=use_kernel)
    B, S = x.shape[:2]
    return o.reshape(B, S, -1) @ params["wo"]


def head_block(H: int, m: int, c: int) -> tuple[int, int]:
    """The heads [h0, h1) that the block of coordinate ``c`` of ``m`` touches
    when the columns of ``H`` heads are cut into ``m`` equal blocks."""
    return c * H // m, -(-(c + 1) * H // m)


def _heads(name, w, H, width, tp, h0, h1):
    """The columns of heads [h0, h1) of a leaf of H heads of ``width``
    columns each, from the rank's cut ``w``: its own columns where the
    heads split over the axis, else the gathered leaf's."""
    L.expect_cut(name, w, 1, H * width, tp)
    if H % tp.size == 0:
        return w
    return tp.gather_cols(w)[:, h0 * width:h1 * width]


def _own_columns(o, H, width, tp, h0):
    """The rank's block of the (B, S, H·width) output columns, from the
    (B, S, (h1 - h0)·width) of the heads it computed."""
    lo = tp.coord * H * width // tp.size - h0 * width
    return o[..., lo:lo + H * width // tp.size]


def kv_heads_read(H: int, Hkv: int, h0: int, h1: int) -> tuple[int, int, list[int]]:
    """(k0, k1, pick): the KV heads [k0, k1) that query heads [h0, h1) read
    (query head h reads KV head h // (H / Hkv)), and for each of those
    query heads the index of its KV head within [k0, k1)."""
    G = H // Hkv
    k0, k1 = h0 // G, (h1 - 1) // G + 1
    return k0, k1, [h // G - k0 for h in range(h0, h1)]


def _kv_for_heads(k, v, pick):
    """k and v (B, S, n, ·) as the GQA kernel reads them for query heads
    whose KV heads are ``pick``: as they are where ``pick`` is the
    kernel's own h // (nq / n), else one KV head a query head."""
    nq, n = len(pick), k.shape[2]
    if nq % n == 0 and pick == [i // (nq // n) for i in range(nq)]:
        return k, v
    idx = torch.tensor(pick, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _gqa_train_tp(params, x, cfg, positions, mrope_positions, use_kernel, tp):
    H, Hkv, hd, m = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, tp.size
    h0, h1 = head_block(H, m, tp.coord)
    L.expect_cut("wo", params["wo"], 0, H * hd, tp)
    for key in ("wk", "wv"):
        L.expect_cut(key, params[key], 1, Hkv * hd, tp)
    wq = _heads("wq", params["wq"], H, hd, tp, h0, h1)
    k0, k1, pick = kv_heads_read(H, Hkv, h0, h1)
    # where the KV heads split, the rank's own columns are those its query heads read
    wk = _heads("wk", params["wk"], Hkv, hd, tp, k0, k1)
    wv = _heads("wv", params["wv"], Hkv, hd, tp, k0, k1)
    x = tp.col_in(x)
    B, S, _ = x.shape
    q = (x @ wq).reshape(B, S, h1 - h0, hd)
    k = (x @ wk).reshape(B, S, k1 - k0, hd)
    v = (x @ wv).reshape(B, S, k1 - k0, hd)
    q, k = _rotate_qk(q, k, cfg, positions, mrope_positions)
    k, v = _kv_for_heads(k, v, pick)
    o = gqa_attention(q, k, v, causal=True, window=cfg.sliding_window, use_kernel=use_kernel)
    o = _own_columns(o.reshape(B, S, -1), H, hd, tp, h0)
    return tp.row_out(o @ params["wo"])


def gqa_decode(params, x, cache, cfg, position, mrope_positions=None, tp=None):
    """x: (B, 1, d); cache: {'k','v'}: (B, kv_heads, max_seq, hd); position
    an int OR a (B,) tensor (per-slot positions — continuous batching).
    The new key and value are written into ``cache`` in place. With ``tp``
    the leaves are the rank's cut and the cache its (B, kv_heads, S_loc,
    hd) block of the sequence (module docstring)."""
    B = x.shape[0]
    hd = cfg.head_dim
    pos_b = torch.as_tensor(position, dtype=torch.long, device=x.device).expand(B)
    if tp is not None:
        return _gqa_decode_tp(params, x, cache, cfg, pos_b, mrope_positions, tp), cache
    q, k, v = _project_qkv(params, x, cfg, positions=pos_b[:, None],
                           mrope_positions=mrope_positions)
    ck, cv = cache["k"], cache["v"]
    bidx = torch.arange(B, device=x.device)
    ck[bidx, :, pos_b] = k[:, 0].to(ck.dtype)
    cv[bidx, :, pos_b] = v[:, 0].to(cv.dtype)
    # masked single-query attention over the cache (memory-bound: plain torch)
    G = cfg.n_heads // cfg.n_kv_heads
    qh = q.reshape(B, 1, cfg.n_kv_heads, G, hd)
    s = torch.einsum("bqhgd,bhkd->bhgk", qh.float(), ck.float())
    s = s * (hd ** -0.5)
    kpos = torch.arange(ck.shape[2], device=x.device)
    valid = kpos[None, :] <= pos_b[:, None]  # (B, S)
    if cfg.sliding_window is not None:
        valid &= kpos[None, :] > pos_b[:, None] - cfg.sliding_window
    s = torch.where(valid[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, cv.float())
    o = o.reshape(B, 1, cfg.n_heads * hd).to(x.dtype)
    return o @ params["wo"], cache


def _gather_columns(tp, *parts):
    """Each of ``parts`` (..., n_i) the rank's block of a projection's
    columns: the whole projections, gathered in one all-gather."""
    widths = [t.shape[-1] for t in parts]
    whole = tp.gather_last(torch.cat(parts, dim=-1))
    whole = whole.reshape(*whole.shape[:-1], tp.size, sum(widths))
    return [t.flatten(-2) for t in whole.split(widths, dim=-1)]


def _owned(pos_b, S_loc: int, tp):
    """(at, mine) of each row: its position within the rank's block of the
    sequence (clamped into it), and whether the rank's block holds it."""
    at = pos_b - tp.coord * S_loc
    return at.clamp(0, S_loc - 1), (at >= 0) & (at < S_loc)


def _visible(pos_b, S_loc: int, tp, window):
    """(B, S_loc): which keys of the rank's block each row's query sees, by
    their global positions."""
    kpos = tp.coord * S_loc + torch.arange(S_loc, device=pos_b.device)
    valid = kpos[None, :] <= pos_b[:, None]
    if window is not None:
        valid &= kpos[None, :] > pos_b[:, None] - window
    return valid


def _joined(s, v, spec: str, tp):
    """The softmax over every rank's keys of the masked float32 scores ``s``
    (..., S_loc) of the rank's block, applied to ``v`` by the einsum
    ``spec`` (its output (..., e) over the scores' leading dims): the
    rank's partial (o, m, l), joined over the axis."""
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return CL.lse_combine(torch.einsum(spec, p, v), m, p.sum(dim=-1), tp)


def _gqa_decode_tp(params, x, cache, cfg, pos_b, mrope_positions, tp):
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    L.expect_cut("wq", params["wq"], 1, H * hd, tp)
    for key in ("wk", "wv"):
        L.expect_cut(key, params[key], 1, Hkv * hd, tp)
    L.expect_cut("wo", params["wo"], 0, H * hd, tp)
    B = x.shape[0]
    q, k, v = _gather_columns(tp, x @ params["wq"], x @ params["wk"], x @ params["wv"])
    q, k = _rotate_qk(q.reshape(B, 1, H, hd), k.reshape(B, 1, Hkv, hd), cfg, pos_b[:, None],
                      mrope_positions)
    v = v.reshape(B, 1, Hkv, hd)
    ck, cv = cache["k"], cache["v"]
    S_loc = ck.shape[2]
    at, mine = _owned(pos_b, S_loc, tp)
    bidx = torch.arange(B, device=x.device)
    ck[bidx, :, at] = torch.where(mine[:, None, None], k[:, 0].to(ck.dtype), ck[bidx, :, at])
    cv[bidx, :, at] = torch.where(mine[:, None, None], v[:, 0].to(cv.dtype), cv[bidx, :, at])
    G = H // Hkv
    qh = q.reshape(B, 1, Hkv, G, hd)
    s = torch.einsum("bqhgd,bhkd->bhgk", qh.float(), ck.float()) * (hd ** -0.5)
    valid = _visible(pos_b, S_loc, tp, cfg.sliding_window)
    s = torch.where(valid[:, None, None, :], s, -1e30)
    o = _joined(s, cv.float(), "bhgk,bhkd->bhgd", tp)
    o = o.reshape(B, 1, H * hd).to(x.dtype)
    return tp.row_out(_own_columns(o, H, hd, tp, 0) @ params["wo"])


def gqa_cache_init(cfg, batch, max_seq, dtype, device):
    hd = cfg.head_dim
    return {
        "k": torch.zeros((batch, cfg.n_kv_heads, max_seq, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, cfg.n_kv_heads, max_seq, hd), dtype=dtype, device=device),
    }


# ================================================================= MLA
# DeepSeek-V3 Multi-head Latent Attention: queries through a low-rank path,
# keys and values expanded from a compressed latent c_kv (cached) plus one
# shared rotary key k_rope. Decode caches only (c_kv, k_rope).
def mla_init(gen, cfg, dtype, device):
    d = cfg.d_model
    m = cfg.mla
    s = d ** -0.5
    qh = m.qk_nope_head_dim + m.qk_rope_head_dim
    kv_out = cfg.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
    o_in = cfg.n_heads * m.v_head_dim

    def tn(shape, scale):
        return L.truncated_normal(gen, shape, dtype, scale, device)

    return {
        "wq_a": tn((d, m.q_lora_rank), s),
        "wq_b": tn((m.q_lora_rank, cfg.n_heads * qh), m.q_lora_rank ** -0.5),
        "wkv_a": tn((d, m.kv_lora_rank + m.qk_rope_head_dim), s),
        "wkv_b": tn((m.kv_lora_rank, kv_out), m.kv_lora_rank ** -0.5),
        "wo": tn((o_in, d), o_in ** -0.5),
        "q_norm": L.rmsnorm_init(m.q_lora_rank, dtype, device),
        "kv_norm": L.rmsnorm_init(m.kv_lora_rank, dtype, device),
    }


def mla_specs(cfg, rules):
    return {
        "wq_a": (None, None),
        "wq_b": rules.attn_in((0, 0)),
        "wkv_a": (None, None),
        "wkv_b": rules.attn_in((0, 0)),
        "wo": rules.attn_out((0, 0)),
        "q_norm": {"scale": (None,)},
        "kv_norm": {"scale": (None,)},
    }


def _mla_qkv(params, x, cfg, positions, H=None, gather_q=None):
    """``H`` the heads ``wq_b`` holds (all of them, or the rank's); with
    ``gather_q`` (the decode's tensor axis) ``wq_b`` is the rank's column
    cut and q is gathered whole over the axis."""
    B, S, _ = x.shape
    m = cfg.mla
    q_lat = L.rmsnorm(params["q_norm"], x @ params["wq_a"])
    q = q_lat @ params["wq_b"]
    if gather_q is not None:
        (q,) = _gather_columns(gather_q, q)
    q = q.reshape(B, S, H or cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = (x @ params["wkv_a"]).split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_kv = L.rmsnorm(params["kv_norm"], c_kv)
    k_rope = L.apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)  # 1 shared head
    return q_nope, q_rope, c_kv, k_rope[:, :, 0, :]


def _mla_expand_kv(params, c_kv, cfg, H=None):
    """(k_nope, v), each (B, S, H, ·): views of one product, ``H`` the
    heads ``wkv_b`` holds (all of them, or the rank's). A float32 latent
    (the engine's cache) times a bf16 ``wkv_b`` runs in float32, as JAX
    promotes it."""
    m = cfg.mla
    B, S, _ = c_kv.shape
    w = params["wkv_b"]
    dt = torch.promote_types(c_kv.dtype, w.dtype)
    kv = (c_kv.to(dt) @ w.to(dt)).reshape(B, S, H or cfg.n_heads,
                                          m.qk_nope_head_dim + m.v_head_dim)
    return kv.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)


def mla_train(params, x, cfg, positions, use_kernel=True, tp=None):
    """With ``use_kernel`` K4 takes q and k of head dim qk_nope + qk_rope
    and v at its own head dim, a strided view of the expanded latent (the
    JAX package pads v to q's head dim for its kernel and slices the output
    back: the same numbers). Without, the materialising ``attention_ref``
    on (B·H, S, ·) operands, as in the JAX package. Both scale by
    1/sqrt(qk_nope + qk_rope). With ``tp`` on the rank's heads (module
    docstring): ``wq_b`` and ``wkv_b`` cut by columns, ``wo`` by rows.
    Runs under the profiler label ``attn.mla``."""
    with record_function("attn.mla"):
        return _mla_train(params, x, cfg, positions, use_kernel, tp)


def _mla_train(params, x, cfg, positions, use_kernel, tp):
    m = cfg.mla
    H = cfg.n_heads
    if tp is not None:
        h0, h1 = head_block(H, tp.size, tp.coord)
        L.expect_cut("wo", params["wo"], 0, H * m.v_head_dim, tp)
        params = dict(params,
                      wq_b=_heads("wq_b", params["wq_b"], H,
                                  m.qk_nope_head_dim + m.qk_rope_head_dim, tp, h0, h1),
                      wkv_b=_heads("wkv_b", params["wkv_b"], H,
                                   m.qk_nope_head_dim + m.v_head_dim, tp, h0, h1))
        x = tp.col_in(x)
        H = h1 - h0
    B, S, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, x, cfg, positions, H)
    k_nope, v = _mla_expand_kv(params, c_kv, cfg, H)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, m.qk_rope_head_dim)], dim=-1)
    if use_kernel:
        o = gqa_attention(q, k, v, causal=True, use_kernel=True)
    else:
        def heads_first(t):  # (B, S, H, e) -> (B·H, S, e)
            return t.transpose(1, 2).reshape(B * H, S, t.shape[-1])

        o = attention_ref(heads_first(q), heads_first(k), heads_first(v), causal=True,
                          scale=q.shape[-1] ** -0.5)
        o = o.reshape(B, H, S, m.v_head_dim).transpose(1, 2)
    o = o.reshape(B, S, H * m.v_head_dim)
    if tp is None:
        return o @ params["wo"]
    o = _own_columns(o, cfg.n_heads, m.v_head_dim, tp, h0)
    return tp.row_out(o @ params["wo"])


def mla_decode(params, x, cache, cfg, position, tp=None):
    """x: (B, 1, d); latent cache {'c_kv': (B, max_seq, r), 'k_rope':
    (B, max_seq, dr)}; position an int or a (B,) tensor. The new latent
    and rotary key are written into ``cache`` in place; the whole latent
    cache is expanded through ``wkv_b`` every step, as in the JAX package.
    With ``tp`` the cache is the rank's (B, S_loc, ·) block of the
    sequence, ``wq_b`` and ``wkv_b`` the rank's column cut and ``wo`` its
    row cut (module docstring)."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    pos_b = torch.as_tensor(position, dtype=torch.long, device=x.device).expand(B)
    if tp is not None:
        return _mla_decode_tp(params, x, cache, cfg, pos_b, tp), cache
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(params, x, cfg, pos_b[:, None])
    c, kr = cache["c_kv"], cache["k_rope"]
    bidx = torch.arange(B, device=x.device)
    c[bidx, pos_b] = c_kv_new[:, 0].to(c.dtype)
    kr[bidx, pos_b] = k_rope_new[:, 0].to(kr.dtype)
    k_nope, v = _mla_expand_kv(params, c, cfg)  # (B, S, H, ·)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
    s = s + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), kr.float())
    s = s * scale
    valid = torch.arange(c.shape[1], device=x.device)[None, :] <= pos_b[:, None]  # (B, S)
    s = torch.where(valid[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o = o.reshape(B, 1, H * m.v_head_dim).to(x.dtype)
    return o @ params["wo"], cache


def _mla_decode_tp(params, x, cache, cfg, pos_b, tp):
    m = cfg.mla
    H = cfg.n_heads
    L.expect_cut("wq_b", params["wq_b"], 1, H * (m.qk_nope_head_dim + m.qk_rope_head_dim), tp)
    L.expect_cut("wkv_b", params["wkv_b"], 1, H * (m.qk_nope_head_dim + m.v_head_dim), tp)
    L.expect_cut("wo", params["wo"], 0, H * m.v_head_dim, tp)
    B = x.shape[0]
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(params, x, cfg, pos_b[:, None],
                                                    gather_q=tp)
    c, kr = cache["c_kv"], cache["k_rope"]
    S_loc = c.shape[1]
    at, mine = _owned(pos_b, S_loc, tp)
    bidx = torch.arange(B, device=x.device)
    c[bidx, at] = torch.where(mine[:, None], c_kv_new[:, 0].to(c.dtype), c[bidx, at])
    kr[bidx, at] = torch.where(mine[:, None], k_rope_new[:, 0].to(kr.dtype), kr[bidx, at])
    k_nope, v = _mla_expand_kv(dict(params, wkv_b=tp.gather_cols(params["wkv_b"])), c, cfg)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
    s = s + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), kr.float())
    s = s * scale
    s = torch.where(_visible(pos_b, S_loc, tp, None)[:, None, None, :], s, -1e30)
    o = _joined(s, v.float(), "bhqk,bkhd->bhqd", tp)  # (B, H, 1, dv)
    o = o.transpose(1, 2).reshape(B, 1, H * m.v_head_dim).to(x.dtype)
    return tp.row_out(_own_columns(o, H, m.v_head_dim, tp, 0) @ params["wo"])


def mla_cache_init(cfg, batch, max_seq, dtype, device):
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, max_seq, m.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_seq, m.qk_rope_head_dim), dtype=dtype, device=device),
    }
