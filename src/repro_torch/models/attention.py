"""Attention: GQA (+ sliding window, + M-RoPE for Qwen2-VL). Train path
(full sequence, flash kernel) and decode path (single token, KV cache).

The port of the GQA/SWA half of ``repro.models.attention``. MLA (DeepSeek
latent attention) waits for the DeepSeek slice (ROADMAP Queue 1 item 3):
``models.model`` refuses its configs with ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import gqa_attention
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

    The new key and value are written into ``cache`` in place (the JAX
    package returns an updated copy); the cache is returned all the same."""
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

