"""Attention variants: GQA (+ sliding window, + M-RoPE for Qwen2-VL) and
MLA (DeepSeek latent attention). Train path (full sequence, flash kernel)
and decode path (single token, KV or latent cache).

The port of ``repro.models.attention``; the sharding specs (``gqa_specs``,
``mla_specs``) are not ported. The decode paths write the new token into
the cache in place (the JAX package returns an updated copy) and return
the cache all the same.
"""

from __future__ import annotations

import torch
from torch.autograd.profiler import record_function

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


def _project_qkv(params, x, cfg, positions, mrope_positions=None):
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = (x @ params["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (x @ params["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ params["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.rope == "mrope":
        q = L.apply_mrope(q, mrope_positions, cfg.mrope_sections, cfg.rope_theta)
        k = L.apply_mrope(k, mrope_positions, cfg.mrope_sections, cfg.rope_theta)
    elif cfg.rope == "rope":
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_train(params, x, cfg, positions, mrope_positions=None, use_kernel=True):
    q, k, v = _project_qkv(params, x, cfg, positions, mrope_positions)
    o = gqa_attention(q, k, v, causal=True, window=cfg.sliding_window, use_kernel=use_kernel)
    B, S = x.shape[:2]
    return o.reshape(B, S, -1) @ params["wo"]


def gqa_decode(params, x, cache, cfg, position, mrope_positions=None):
    """x: (B, 1, d); cache: {'k','v'}: (B, kv_heads, max_seq, hd); position
    an int OR a (B,) tensor (per-slot positions — continuous batching).
    The new key and value are written into ``cache`` in place."""
    B = x.shape[0]
    hd = cfg.head_dim
    pos_b = torch.as_tensor(position, dtype=torch.long, device=x.device).expand(B)
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


def _mla_qkv(params, x, cfg, positions):
    B, S, _ = x.shape
    m = cfg.mla
    q_lat = L.rmsnorm(params["q_norm"], x @ params["wq_a"])
    q = (q_lat @ params["wq_b"]).reshape(B, S, cfg.n_heads,
                                         m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = (x @ params["wkv_a"]).split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_kv = L.rmsnorm(params["kv_norm"], c_kv)
    k_rope = L.apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)  # 1 shared head
    return q_nope, q_rope, c_kv, k_rope[:, :, 0, :]


def _mla_expand_kv(params, c_kv, cfg):
    """(k_nope, v), each (B, S, H, ·): views of one product. A float32
    latent (the engine's cache) times a bf16 ``wkv_b`` runs in float32, as
    JAX promotes it."""
    m = cfg.mla
    B, S, _ = c_kv.shape
    w = params["wkv_b"]
    dt = torch.promote_types(c_kv.dtype, w.dtype)
    kv = (c_kv.to(dt) @ w.to(dt)).reshape(B, S, cfg.n_heads, m.qk_nope_head_dim + m.v_head_dim)
    return kv.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)


def mla_train(params, x, cfg, positions, use_kernel=True):
    """With ``use_kernel`` K4 takes q and k of head dim qk_nope + qk_rope
    and v at its own head dim, a strided view of the expanded latent (the
    JAX package pads v to q's head dim for its kernel and slices the output
    back: the same numbers). Without, the materialising ``attention_ref``
    on (B·H, S, ·) operands, as in the JAX package. Both scale by
    1/sqrt(qk_nope + qk_rope). Runs under the profiler label ``attn.mla``."""
    with record_function("attn.mla"):
        return _mla_train(params, x, cfg, positions, use_kernel)


def _mla_train(params, x, cfg, positions, use_kernel):
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, x, cfg, positions)
    k_nope, v = _mla_expand_kv(params, c_kv, cfg)
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
    return o.reshape(B, S, H * m.v_head_dim) @ params["wo"]


def mla_decode(params, x, cache, cfg, position):
    """x: (B, 1, d); latent cache {'c_kv': (B, max_seq, r), 'k_rope':
    (B, max_seq, dr)}; position an int or a (B,) tensor. The new latent
    and rotary key are written into ``cache`` in place; the whole latent
    cache is expanded through ``wkv_b`` every step, as in the JAX package."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    pos_b = torch.as_tensor(position, dtype=torch.long, device=x.device).expand(B)
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


def mla_cache_init(cfg, batch, max_seq, dtype, device):
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, max_seq, m.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_seq, m.qk_rope_head_dim), dtype=dtype, device=device),
    }
