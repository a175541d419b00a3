"""Language model wrapper: embedding -> (dense prefix) -> main stack ->
final norm -> logits, plus the DeepSeek-style MTP head, the loss, and the
decode step. All entry points are plain functions of (params, batch).

The port of ``repro.models.model`` for every arch of the registry (GQA,
MLA, Mamba and xLSTM members with dense, MoE or no FFNs), with
``decode_step_staged``, the decode step that pauses at each MoE boundary
for the multi-tenant fleet. DeepSeek-V3's
dense prefix (``first_dense_layers``) is ``params["prefix"]``, a list of
per-layer dicts like the stack (the JAX package stacks it in a
one-tuple), and its multi-token-prediction head ``params["mtp"]`` is
``{"proj", "norm", "block"}``, the block one dense member.
``param_specs`` and ``cache_specs`` give the sharding spec of every leaf
of those trees (a plain tuple, ``dist.sharding.Spec``): each layer of the
stack and of the prefix takes the JAX package's stacked spec without its
leading entry, and each prefix layer's cache the stack's first member's.
``dist.sharding.local_slices`` turns a spec into what a rank holds.

Under active rules (``dist.sharding.set_active``) the train path
(``forward_train``, ``loss_fn``) is tensor-parallel on the mesh's tensor
axis and takes the rank's compute leaves (``compute_specs``: the mixers',
the FFNs', the embedding's and the unembedding's leaves cut as
``param_specs`` cuts them on that axis, everything else whole;
``local_params`` cuts a whole tree so, as views): the embedding looks up
the rank's d-slice and gathers it, each block runs on the rank's heads,
Mamba, mLSTM or sLSTM channels and ff slice, and the logits come cut on
the vocabulary, the cross entropy taking its max, its sum of exponentials
and the target's logit over the axis (``softmax_xent``). ``whole_logits``
gathers them. The decode (``decode_step``) is tensor-parallel on the same
compute leaves, each cache leaf the rank's ``cache_specs`` shard (an
attention cache its block of the sequence, a recurrent state its block
of the inner or feature dim), and returns every vocabulary entry of the
rank's rows.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import collectives as CL
from repro_torch.dist import sharding as SH
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


def param_specs(cfg: ModelConfig, rules):
    """The sharding spec of every parameter, in ``init_params``' tree."""
    s = {
        "embed": {"table": rules.embed((cfg.vocab, cfg.d_model))},
        "final_norm": L.norm_specs(cfg.norm),
        "stack": T.stack_specs(cfg, rules),
    }
    if not cfg.tie_embeddings:
        s["unembed"] = {"w": rules.attn_in((cfg.d_model, cfg.vocab))}
    if cfg.first_dense_layers:
        s["prefix"] = [T.member_specs(cfg, rules, "attn", "mlp")
                       for _ in range(cfg.first_dense_layers)]
    if cfg.mtp_depth:
        s["mtp"] = {
            "proj": (None, None),
            "norm": L.norm_specs(cfg.norm),
            "block": T.member_specs(cfg, rules, "attn", "mlp"),
        }
    return s


def _member_cut(path) -> bool:
    """Whether the leaf at ``path`` (of ``init_params``' tree) is computed
    cut on the tensor axis: a member's mixer (attention, Mamba, mLSTM or
    sLSTM) and FFN (the dense MLP, a MoE layer's shared expert and expert
    stacks) in the stack, the dense prefix and the MTP block, the
    embedding table and the unembedding, each as far as its spec cuts it
    (norms, the router, MLA's ``wq_a`` and ``wkv_a``, the mLSTM's
    block-diagonal ``wq``, ``wk``, ``wv`` are whole in their specs). The
    rest (the final norm, the MTP projection and norm) is computed whole."""
    if path[0] in ("embed", "unembed"):
        return True
    member = path[0] in ("stack", "prefix") or path[:2] == ("mtp", "block")
    return member and path[2] in ("mixer", "ffn")


def compute_specs(cfg: ModelConfig, rules):
    """The spec every parameter is computed under on a rank of the train
    path (``forward_train`` under active rules): ``param_specs``'
    tensor-axis entries of the leaves computed cut (``_member_cut``),
    every other entry whole. ``dist.sharding.local_slices`` of it gives
    the rank's compute leaf."""
    from repro_torch.train import optimizer as O  # the tree helpers; train imports models

    def keep(path, spec):
        if not _member_cut(path):
            return tuple(None for _ in spec)
        return tuple(e if e == rules.tensor_axis else None for e in spec)

    return O.map_specs(param_specs(cfg, rules), keep)


def local_params(params, cfg: ModelConfig, rules, coords, sizes):
    """A whole parameter tree cut, as views, to the compute leaves of the
    rank at ``coords`` of a mesh of ``sizes`` (``compute_specs``)."""
    from repro_torch.train import optimizer as O

    specs = compute_specs(cfg, rules)
    return O.unflatten(params, [w[SH.local_slices(O.get(specs, path), w.shape, coords, sizes)]
                                for path, w in O.flatten(params)])


# --------------------------------------------------------------- forward
def _embed_inputs(params, batch, cfg, tp=None):
    if cfg.embeds_input and "embeds" in batch:
        x = batch["embeds"].to(_dtype(cfg.compute_dtype))
        B, S = x.shape[:2]
    else:
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = L.embed_apply(params["embed"], tokens, tp, cfg.d_model).to(_dtype(cfg.compute_dtype))
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    return x, positions, batch.get("mrope_positions")


def forward_train(params, batch, cfg: ModelConfig, use_kernel: bool = True,
                  remat: bool = True):
    """-> (logits (B, S, vocab), aux_loss, hidden (B, S, d)). ``aux_loss``
    is the float32 sum of the MoE layers' load-balance losses (zero
    without MoE layers); the dense prefix runs before the stack. With
    ``remat`` and autograd recording, each prefix layer and each group of
    the stack runs under ``torch.utils.checkpoint``, as the JAX package
    runs them under ``jax.checkpoint``. Under active rules the rank's
    compute leaves (module docstring) give the rank's (B, S, vocab / m)
    slice of the logits; with ``seq_parallel`` the blocks run on the
    rank's block of the sequence, gathered after the final norm."""
    tp = CL.tensor_parallel()
    x, positions, mrope = _embed_inputs(params, batch, cfg, tp)
    sp = tp is not None and tp.seq_parallel
    if sp:
        x = tp.own_seq(x)
    for member in params.get("prefix", []):  # dense members: their aux is 0
        x = T.remat_call(
            lambda x, member=member: T.member_train(member, x, cfg, "attn", "mlp", positions,
                                                    mrope, use_kernel)[0], x, remat)
    x, aux = T.stack_train(params["stack"], x, cfg, positions, mrope, use_kernel, remat)
    h = _norm_f(cfg)(params["final_norm"], x)
    if sp:
        h = tp.gather_seq(h)
    logits = _unembed(params, h, cfg, tp)
    return logits, aux, h


def _norm_f(cfg):
    return L.rmsnorm if cfg.norm == "rmsnorm" else L.layernorm


def _unembed(params, h, cfg, tp=None):
    if cfg.tie_embeddings:
        return L.unembed_apply(params["embed"], h, tp, cfg.d_model)
    if tp is not None:
        L.expect_cut("unembed/w", params["unembed"]["w"], 1, cfg.vocab, tp)
    return h @ params["unembed"]["w"]


def whole_logits(logits):
    """Logits cut on the vocabulary under active rules, gathered whole over
    the tensor axis (outside autograd); as they are with no rules active."""
    tp = CL.tensor_parallel()
    if tp is None or tp.size == 1:
        return logits
    with torch.no_grad():
        return tp.gather_last(logits)


def mtp_logits(params, h, batch, cfg, use_kernel=True):
    """DeepSeek MTP: predict token t+2 from [h_t ; emb(token_{t+1})]
    through one extra block sharing the embedding and unembedding; the
    last position sees token 0. Under active rules as ``forward_train``."""
    tp = CL.tensor_parallel()
    tokens = batch["tokens"]
    B, S = tokens.shape
    nxt = torch.cat([tokens[:, 1:], tokens.new_zeros((B, 1))], dim=1)
    e = L.embed_apply(params["embed"], nxt, tp, cfg.d_model).to(h.dtype)
    z = torch.cat([_norm_f(cfg)(params["mtp"]["norm"], h), e], dim=-1) @ params["mtp"]["proj"]
    positions = torch.arange(S, dtype=torch.int32, device=h.device).expand(B, S)
    sp = tp is not None and tp.seq_parallel
    if sp:
        z = tp.own_seq(z)
    z = T.member_train(params["mtp"]["block"], z, cfg, "attn", "mlp", positions, None,
                       use_kernel)[0]
    if sp:
        z = tp.gather_seq(z)
    return _unembed(params, z, cfg, tp)


def softmax_xent(logits, labels, valid=None, tp=None):
    """The mean cross entropy. With ``tp`` the logits are the rank's
    (…, vocab / m) slice on the tensor axis (vocabulary block ``tp.coord``):
    the max, the sum of exponentials and the target's logit are each taken
    over the axis in float32 (the max outside autograd), so every rank
    holds the whole loss. Computed in float32 (float64 logits stay
    float64)."""
    lf = logits.to(torch.promote_types(logits.dtype, torch.float32))
    if tp is None:
        logz = torch.logsumexp(lf, dim=-1)
        ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    else:
        top = tp.max(lf.amax(dim=-1))
        logz = torch.log(tp.sum(torch.exp(lf - top[..., None]).sum(-1))) + top
        Vl = lf.shape[-1]
        at = labels.long() - tp.coord * Vl
        mine = (at >= 0) & (at < Vl)
        ll = torch.gather(lf, -1, at.clamp(0, Vl - 1)[..., None])[..., 0]
        ll = tp.sum(torch.where(mine, ll, torch.zeros_like(ll)))
    nll = logz - ll
    if valid is None:
        return nll.mean()
    return (nll * valid).sum() / valid.sum().clamp(min=1)


def loss_fn(params, batch, cfg: ModelConfig, use_kernel: bool = True, remat: bool = True):
    logits, aux, h = forward_train(params, batch, cfg, use_kernel, remat)
    tp = CL.tensor_parallel()
    labels = batch["labels"]
    loss = softmax_xent(logits[:, :-1], labels[:, 1:], tp=tp)
    metrics = {"ce": loss}
    if cfg.moe is not None:
        loss = loss + cfg.moe.aux_loss_weight * aux
        metrics["moe_aux"] = aux
    if cfg.mtp_depth and "tokens" in batch:
        ml = mtp_logits(params, h, batch, cfg, use_kernel)
        mtp_loss = softmax_xent(ml[:, :-2], labels[:, 2:], tp=tp)
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


def cache_specs(cfg: ModelConfig, rules, long_context: bool):
    """The sharding spec of every decode state, in ``init_cache``' tree;
    each prefix layer takes the stack's first layer's, as in the JAX
    package."""
    s = {"stack": T.stack_cache_specs(cfg, rules, long_context)}
    if cfg.first_dense_layers:
        s["prefix"] = [T.stack_cache_specs(cfg, rules, long_context)[0]
                       for _ in range(cfg.first_dense_layers)]
    return s


def decode_step(params, cache, batch, position, cfg: ModelConfig):
    """One token for the whole batch at ``position`` (an int or (B,) tensor).

    batch: {'token': (B,)} or {'embed': (B, d)} (+ mrope positions).
    Returns (logits (B, vocab), cache): the KV caches are updated in place,
    the recurrent states (Mamba, mLSTM, sLSTM) come back as new tensors.
    ``decode_step_staged`` with every MoE boundary answered inline.

    Under active rules the parameters are the rank's compute leaves
    (``local_params``; a whole leaf where a cut one is due raises
    ``ValueError``), the batch the rank's rows, and each cache leaf the
    rank's block of ``cache_specs``, never gathered: an attention cache its
    rows and its block of the sequence, a Mamba, mLSTM or sLSTM state its
    rows and its block of the inner or feature dim; the logits are the
    rank's rows, every vocabulary entry (the reference's out-sharding).
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
    first, inline. Under active rules as ``decode_step``."""
    tp = T.decode_tp()
    if cfg.embeds_input and "embed" in batch:
        x = batch["embed"][:, None].to(_dtype(cfg.compute_dtype))
    else:
        x = L.embed_apply(params["embed"], batch["token"][:, None], tp,
                          cfg.d_model).to(_dtype(cfg.compute_dtype))
    mrope = batch.get("mrope_positions")
    for member, member_cache in zip(params.get("prefix", []), cache.get("prefix", [])):
        x = T.member_decode(member, x, member_cache, cfg, "attn", "mlp", position, mrope)[0]
    x, stack_cache = yield from T.stack_decode_staged(params["stack"], x, cache["stack"], cfg,
                                                      position, mrope)
    h = _norm_f(cfg)(params["final_norm"], x)
    logits = whole_logits(_unembed(params, h, cfg, tp))
    return logits[:, 0], {**cache, "stack": stack_cache}
