"""Language model wrapper: embedding -> main stack -> final norm -> logits,
the loss, and the decode step. All entry points are plain functions of
(params, batch).

The port of ``repro.models.model`` for the attention models with dense or
MoE FFNs, with ``decode_step_staged``, the decode step that pauses at each
MoE boundary for the multi-tenant fleet. Not ported here: MLA with the
dense prefix and multi-token-prediction head of DeepSeek-V3 (ROADMAP
Queue 1 item 2), and ``param_specs`` and ``cache_specs`` (sharding).
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


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.attention == "mla" or cfg.first_dense_layers or cfg.mtp_depth:
        raise NotImplementedError(
            "MLA, the dense prefix and the MTP head (DeepSeek-V3) are not ported yet: "
            "ROADMAP Queue 1 item 2")


# ------------------------------------------------------------------ init
def init_params(key, cfg: ModelConfig, device="cuda"):
    """Random parameters at the JAX package's scales (truncated normal on
    [-2, 2]). ``key`` is a seed or a ``torch.Generator`` on ``device``;
    the numbers differ from ``jax.random``'s (carry JAX parameters across
    with ``models.convert.params_from_jax``). Runs on the card unless
    ``device="cpu"`` is given, and raises where there is no card."""
    _check_supported(cfg)
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
    without MoE layers)."""
    _check_supported(cfg)
    x, positions, mrope = _embed_inputs(params, batch, cfg)
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
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------- decode
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, device="cuda"):
    _check_supported(cfg)
    dt = dtype or _dtype(cfg.compute_dtype)
    return {"stack": T.stack_cache_init(cfg, batch, max_seq, dt, _device(device))}


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
    boundary. The dense prefix of DeepSeek-V3 waits for MLA
    (``_check_supported``)."""
    _check_supported(cfg)
    if cfg.embeds_input and "embed" in batch:
        x = batch["embed"][:, None].to(_dtype(cfg.compute_dtype))
    else:
        x = L.embed_apply(params["embed"], batch["token"][:, None]).to(_dtype(cfg.compute_dtype))
    x, stack_cache = yield from T.stack_decode_staged(params["stack"], x, cache["stack"], cfg,
                                                      position, batch.get("mrope_positions"))
    h = _norm_f(cfg)(params["final_norm"], x)
    logits = _unembed(params, h, cfg)
    return logits[:, 0], {**cache, "stack": stack_cache}
