"""Language model wrapper: embedding -> (dense prefix) -> main stack ->
final norm -> logits, plus the DeepSeek-style MTP head, the loss, and the
decode step. All entry points are plain functions of (params, batch).

The port of ``repro.models.model`` for the attention models (GQA or MLA)
with dense or MoE FFNs, with ``decode_step_staged``, the decode step that
pauses at each MoE boundary for the multi-tenant fleet. DeepSeek-V3's
dense prefix (``first_dense_layers``) is ``params["prefix"]``, a list of
per-layer dicts like the stack (the JAX package stacks it in a
one-tuple), and its multi-token-prediction head ``params["mtp"]`` is
``{"proj", "norm", "block"}``, the block one dense member. Not ported
here: ``param_specs`` and ``cache_specs`` (sharding).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the model needs a CUDA card and found none; pass "
                           "device='cpu' for the plain torch path")
    return device


# ------------------------------------------------------------------ init
def init_params(key, cfg: ModelConfig, device="cuda"):
    """Random parameters at the JAX package's scales (truncated normal on
    [-2, 2]). ``key`` is a seed or a ``torch.Generator`` on ``device``;
    the numbers differ from ``jax.random``'s (carry JAX parameters across
    with ``models.convert.params_from_jax``). Runs on the card unless
    ``device="cpu"`` is given, and raises where there is no card."""
    device = _device(device)
    gen = key if isinstance(key, torch.Generator) else \
        torch.Generator(device=device).manual_seed(int(key))
    dt = _dtype(cfg.param_dtype)
    p = {
        "embed": L.embed_init(gen, cfg.vocab, cfg.d_model, dt, device),
        "final_norm": L.make_norm(cfg.norm, cfg.d_model, dt, device)[0],
        "stack": T.stack_init(gen, cfg, dt, device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = {"w": L.truncated_normal(gen, (cfg.d_model, cfg.vocab), dt,
                                                cfg.d_model ** -0.5, device)}
    if cfg.first_dense_layers:
        p["prefix"] = [T.member_init(gen, cfg, "attn", "mlp", dt, device)
                       for _ in range(cfg.first_dense_layers)]
    if cfg.mtp_depth:
        d = cfg.d_model
        p["mtp"] = {
            "proj": L.truncated_normal(gen, (2 * d, d), dt, (2 * d) ** -0.5, device),
            "norm": L.make_norm(cfg.norm, d, dt, device)[0],
            "block": T.member_init(gen, cfg, "attn", "mlp", dt, device),
        }
    return p


# --------------------------------------------------------------- forward
def _embed_inputs(params, batch, cfg):
    if cfg.embeds_input and "embeds" in batch:
        x = batch["embeds"].to(_dtype(cfg.compute_dtype))
        B, S = x.shape[:2]
    else:
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = L.embed_apply(params["embed"], tokens).to(_dtype(cfg.compute_dtype))
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    return x, positions, batch.get("mrope_positions")


def forward_train(params, batch, cfg: ModelConfig, use_kernel: bool = True):
    """-> (logits (B, S, vocab), aux_loss, hidden (B, S, d)). ``aux_loss``
    is the float32 sum of the MoE layers' load-balance losses (zero
    without MoE layers); the dense prefix runs before the stack."""
    x, positions, mrope = _embed_inputs(params, batch, cfg)
    for member in params.get("prefix", []):  # dense members: their aux is 0
        x = T.member_train(member, x, cfg, "attn", "mlp", positions, mrope, use_kernel)[0]
    x, aux = T.stack_train(params["stack"], x, cfg, positions, mrope, use_kernel)
    h = _norm_f(cfg)(params["final_norm"], x)
    logits = _unembed(params, h, cfg)
    return logits, aux, h


def _norm_f(cfg):
    return L.rmsnorm if cfg.norm == "rmsnorm" else L.layernorm


def _unembed(params, h, cfg):
    if cfg.tie_embeddings:
        return L.unembed_apply(params["embed"], h)
    return h @ params["unembed"]["w"]


def mtp_logits(params, h, batch, cfg, use_kernel=True):
    """DeepSeek MTP: predict token t+2 from [h_t ; emb(token_{t+1})]
    through one extra block sharing the embedding and unembedding; the
    last position sees token 0."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    nxt = torch.cat([tokens[:, 1:], tokens.new_zeros((B, 1))], dim=1)
    e = L.embed_apply(params["embed"], nxt).to(h.dtype)
    z = torch.cat([_norm_f(cfg)(params["mtp"]["norm"], h), e], dim=-1) @ params["mtp"]["proj"]
    positions = torch.arange(S, dtype=torch.int32, device=h.device).expand(B, S)
    z = T.member_train(params["mtp"]["block"], z, cfg, "attn", "mlp", positions, None,
                       use_kernel)[0]
    return _unembed(params, z, cfg)


def softmax_xent(logits, labels, valid=None):
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = logz - ll
    if valid is None:
        return nll.mean()
    return (nll * valid).sum() / valid.sum().clamp(min=1)


def loss_fn(params, batch, cfg: ModelConfig, use_kernel: bool = True):
    logits, aux, h = forward_train(params, batch, cfg, use_kernel)
    labels = batch["labels"]
    loss = softmax_xent(logits[:, :-1], labels[:, 1:])
    metrics = {"ce": loss}
    if cfg.moe is not None:
        loss = loss + cfg.moe.aux_loss_weight * aux
        metrics["moe_aux"] = aux
    if cfg.mtp_depth and "tokens" in batch:
        ml = mtp_logits(params, h, batch, cfg, use_kernel)
        mtp_loss = softmax_xent(ml[:, :-2], labels[:, 2:])
        loss = loss + 0.3 * mtp_loss
        metrics["mtp"] = mtp_loss
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------- decode
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, device="cuda"):
    dt = dtype or _dtype(cfg.compute_dtype)
    device = _device(device)
    cache = {"stack": T.stack_cache_init(cfg, batch, max_seq, dt, device)}
    if cfg.first_dense_layers:
        cache["prefix"] = [T.member_cache_init(cfg, "attn", batch, max_seq, dt, device)
                           for _ in range(cfg.first_dense_layers)]
    return cache


def decode_step(params, cache, batch, position, cfg: ModelConfig):
    """One token for the whole batch at ``position`` (an int or (B,) tensor).

    batch: {'token': (B,)} or {'embed': (B, d)} (+ mrope positions).
    Returns (logits (B, vocab), cache); the KV caches are updated in place.
    ``decode_step_staged`` with every MoE boundary answered inline.
    """
    return T.serve_inline(decode_step_staged(params, cache, batch, position, cfg), cfg)


def decode_step_staged(params, cache, batch, position, cfg: ModelConfig):
    """``decode_step`` as a generator that pauses at every MoE boundary.

    The expert FFNs are not computed inline: ``transformer.stack_decode_staged``
    yields ``(ffn_params, h2)`` at each MoE member and expects the expert
    output sent back. Drive it with ``next()`` and ``gen.send(y)``;
    ``StopIteration.value`` is ``(logits (B, vocab), cache)``. The
    multi-tenant fleet's engines (``serve.fleet``) decode with it, so that
    N tenants' expert dispatches share one combined program replay a
    boundary. The dense prefix (DeepSeek-V3) has no MoE member and runs
    first, inline."""
    if cfg.embeds_input and "embed" in batch:
        x = batch["embed"][:, None].to(_dtype(cfg.compute_dtype))
    else:
        x = L.embed_apply(params["embed"], batch["token"][:, None]).to(_dtype(cfg.compute_dtype))
    mrope = batch.get("mrope_positions")
    for member, member_cache in zip(params.get("prefix", []), cache.get("prefix", [])):
        x = T.member_decode(member, x, member_cache, cfg, "attn", "mlp", position, mrope)[0]
    x, stack_cache = yield from T.stack_decode_staged(params["stack"], x, cache["stack"], cfg,
                                                      position, mrope)
    h = _norm_f(cfg)(params["final_norm"], x)
    logits = _unembed(params, h, cfg)
    return logits[:, 0], {**cache, "stack": stack_cache}
