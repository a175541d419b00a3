"""Training step factory: loss -> grads (with microbatch accumulation) ->
optional int8 error-feedback compression -> AdamW/AdaFactor update.

The port of ``repro.train.train_step`` for one process: the gradients
come from ``torch.autograd.grad`` over the parameter leaves (a leaf the
loss does not reach gets zeros, as under ``jax.value_and_grad``), the
microbatches run one after another and their float32 gradients are
summed (the JAX package's ``lax.scan``), and the loss is the mean over
the microbatches. The step runs under the profiler labels
``train.forward``, ``train.backward`` and ``train.optimizer``. Not
ported: ``unroll`` (XLA cost analysis) and ``train_shardings`` (the
sharding spec trees); they wait for the dry run and the multi-process
step.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.autograd.profiler import record_function

from repro_torch.models import model as M
from repro_torch.train import compression as C
from repro_torch.train import optimizer as O


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    microbatches: int = 1          # gradient accumulation steps
    use_kernel: bool = False       # True needs a K4 backward: K4 refuses autograd
    remat: bool = True
    compress_grads: bool = False   # int8 + error feedback


def _value_and_grad(cfg, settings: TrainSettings, params, batch):
    """-> (loss, metrics, grads): detached, grads in the parameters' dtypes."""
    flat = [p for _, p in O.flatten(params)]
    leaves = [p.detach().requires_grad_(True) for p in flat]
    with record_function("train.forward"):
        loss, metrics = M.loss_fn(O.unflatten(params, leaves), batch, cfg,
                                  use_kernel=settings.use_kernel, remat=settings.remat)
    with record_function("train.backward"):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            O.unflatten(params, grads))


def _split(name, x, mb_n: int):
    if name == "mrope_positions":  # (3, B, S): batch on axis 1
        return x.reshape(3, mb_n, -1, *x.shape[2:]).transpose(0, 1)
    return x.reshape(mb_n, -1, *x.shape[1:])


def split_microbatches(batch, mb_n: int):
    """Host-side microbatch split — the layout of the in-step split
    (mrope_positions carries batch on axis 1), as a list of
    per-microbatch dicts so the launcher can time and drop individual
    microbatches (the straggler path)."""
    mbs = {k: _split(k, v, mb_n) for k, v in batch.items()}
    return [{k: v[i] for k, v in mbs.items()} for i in range(mb_n)]


def make_microbatch_grads(cfg, settings: TrainSettings):
    """-> mb_grads(params, microbatch) -> (loss, metrics, grads_f32).

    One microbatch's contribution in isolation, so the launcher can time
    each accumulation step on the host and drop stragglers before they
    enter the sum."""

    def mb_grads(params, mb):
        loss, metrics, g = _value_and_grad(cfg, settings, params, mb)
        return loss, metrics, O.unflatten(g, [x.float() for _, x in O.flatten(g)])

    return mb_grads


def make_apply_step(cfg, opt_cfg: O.OptConfig, settings: TrainSettings):
    """-> apply_step(params, opt_state, grads, loss, metrics) -> (params,
    opt_state, metrics): the optimizer tail of ``make_train_step`` on
    pre-accumulated (already averaged/renormalized) gradients."""
    period = len(cfg.layer_kinds())

    def apply_step(params, opt_state, grads, loss, metrics):
        if settings.compress_grads:
            codes, new_err = C.compress_tree(grads, opt_state["err"], period)
            grads = C.decompress_tree(codes, grads, period)
            opt_state = dict(opt_state, err=new_err)
        inner = {k: v for k, v in opt_state.items() if k != "err"}
        with record_function("train.optimizer"):
            params, inner, opt_metrics = O.apply_updates(params, grads, inner, cfg=opt_cfg)
        new_state = dict(inner)
        if settings.compress_grads:
            new_state["err"] = opt_state["err"]
        metrics = dict(metrics, **opt_metrics)
        metrics["loss"] = loss
        return params, new_state, metrics

    return apply_step


def make_train_step(cfg, opt_cfg: O.OptConfig, settings: TrainSettings):
    """-> train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    batch leading dim = global batch; ``settings.microbatches`` splits it
    into that many microbatches, whose gradients are summed in float32
    and averaged."""
    apply_step = make_apply_step(cfg, opt_cfg, settings)

    def grads_of(params, batch):
        if settings.microbatches == 1:
            return _value_and_grad(cfg, settings, params, batch)
        mb_n = settings.microbatches
        g_sum, loss_sum, metrics = None, 0.0, None
        for mb in split_microbatches(batch, mb_n):
            loss, metrics, g = _value_and_grad(cfg, settings, params, mb)
            flat = [x.float() for _, x in O.flatten(g)]
            g_sum = flat if g_sum is None else [a + b for a, b in zip(g_sum, flat)]
            loss_sum = loss_sum + loss
            del g, flat
        grads = O.unflatten(params, [g / mb_n for g in g_sum])
        return loss_sum / mb_n, metrics, grads

    def train_step(params, opt_state, batch):
        loss, metrics, grads = grads_of(params, batch)
        return apply_step(params, opt_state, grads, loss, metrics)

    return train_step


def init_train_state(key, cfg, opt_cfg: O.OptConfig, settings: TrainSettings, device="cuda"):
    """Random parameters from ``key`` (``models.model.init_params``, on
    ``device``), zero optimizer state, and the compression error where
    ``settings.compress_grads``."""
    params = M.init_params(key, cfg, device=device)
    opt_state = O.init_state(params, opt_cfg)
    if settings.compress_grads:
        opt_state = dict(opt_state, err=C.init_error(params))
    return params, opt_state
