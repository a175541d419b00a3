"""Training step factory: loss -> grads (with microbatch accumulation) ->
optional int8 error-feedback compression -> AdamW/AdaFactor update.

The port of ``repro.train.train_step`` for one process: the gradients
come from ``torch.autograd.grad`` over the parameter leaves (a leaf the
loss does not reach gets zeros, as under ``jax.value_and_grad``), the
microbatches run one after another and their float32 gradients are
summed (the JAX package's ``lax.scan``), and the loss is the mean over
the microbatches. The step runs under the profiler labels
``train.forward``, ``train.backward`` and ``train.optimizer``. Not
ported: ``unroll`` (XLA cost analysis; the port's dry run,
``launch.dryrun``, counts every layer as it runs).

**Shardings.** ``train_shardings(cfg, rules, opt_cfg, settings)`` gives
``(param_specs, opt_specs, batch_specs, None)`` as the reference does, in
the port's per-layer trees: plain rules, FSDP (parameters and optimizer
state sharded over the data axes too) or ``zero1`` (the state alone).
``_maybe_fsdp`` is decided on the reference's stacked shape: ``(G,
*leaf)`` for a layer of the stack, ``(first_dense_layers, *leaf)`` for
the prefix, the port's own shape for the rest. Where it picks the stacked
dim, the layer lies whole on one data coordinate, and its per-layer spec
opens with a ``dist.sharding.Holder(axes, at, of)``: the reference's
stacked spec with the leading entry naming the layer's place (group ``at``
of ``of``) instead of a split. ``dist.sharding.held_slices`` gives any
rank's slices of any leaf, or None. To cut a whole (one-process)
checkpoint by hand for rank r: a leaf whose spec opens with a Holder goes
whole, cut by the rest of its spec, to the ranks whose batch coordinate is
``at // (of / n_data)``, and to no other rank.

**The sharded step.** ``make_sharded_train_step(cfg, opt_cfg, settings)``
gives ``step(params, opt_state, batch)`` on one rank of the mesh that
``dist.sharding.set_active(rules, mesh)`` registered (it raises where
none is). ``shard_train_state`` cuts one-process state to a rank's shards
by the specs and ``gather_train_state`` puts it back whole on every rank;
``shard_batch`` gives a rank its rows. Gathered, the step is the
reference's ``jax.jit(make_train_step, in_shardings=train_shardings(...))``.
The design is simple and right first:

* storage follows the specs exactly: TP shards on the model axis, FSDP or
  ZeRO-1 shards on the data axes, whole layers on their holder, EP's
  expert stacks;
* compute gathers every leaf over the batch axes at the top of the step
  (all-gathers, and a broadcast from a layer's holder), to its compute
  spec (``models.compute_specs``): the leaves the train path computes
  tensor-parallel (the attention, Mamba, mLSTM and sLSTM mixers, the
  dense MLP, a MoE layer's shared expert, the embedding and the
  unembedding) and the MoE expert stacks keep their cut on the model
  axis, the rest (norms, routers) is gathered whole; each rank runs
  ``models.loss_fn`` (remat as in one process) on its batch rows, on its
  heads, channels and ff slice, its logits cut on the vocabulary (and, with
  ``seq_parallel``, its residual stream on its block of the sequence);
* the gradient convention is the SPMD transpose: every rank seeds its
  backward with ``1 / n_ranks`` of its own loss copy, and every collective
  on the forward (``dist.collectives``' differentiable ones in the MoE
  layers and the tensor-parallel blocks) has its transpose as backward
  (all-to-all <-> the same all-to-all, all-gather -> reduce-scatter of the
  sum, all-reduce -> all-reduce; a column block's input is the identity
  both ways, its copies' cotangents left partial for these sums to add).
  A leaf's gradient is then the sum over the ranks holding a copy of it
  in compute (every rank for a leaf computed whole, the batch axes for a
  leaf computed cut on the model axis), of which each rank keeps the
  slices its optimizer state holds. This counts the global loss once: the mean of the data
  shards' ``ce`` plus the aux term's mean over every token shard. The
  sums run in the gradients' dtype (bf16 for bf16 weights; float32 for
  microbatches, whose sum is float32), a leaf at a time on the carrier,
  and are cast to float32 after;
* the optimizer runs on the optimizer state's layout: each rank updates
  the slices its state holds, then the parameters go back to their own
  layout (a gather over ZeRO-1's data shards or from a holder).
  ``grad_norm`` counts each element once (a slice replicated over an axis
  on that axis' coordinate 0 only), and a factored leaf's means that
  cross a sharded dim sum over that dim's axes;
* ``loss``, ``ce``, ``moe_aux``, ``mtp``, ``grad_norm`` and ``lr`` in the
  metrics are the global ones, the same on every rank;
* microbatches run one after another: microbatch i is the reference's,
  rows block i of the global batch, of which each rank takes its data
  shard (the batch is all-gathered over the data axes first, tokens only;
  a microbatch with fewer rows than data coordinates gives each row to an
  equal run of them);
* a ``None`` gradient is zeros only for the ``embed`` table when the
  batch holds ``embeds``; any other raises.

With ``compress_grads`` the step quantizes as the reference's jit does
under its shardings, each 256-value block of a JAX leaf whole (a block
may span two layers, which FSDP may place on different data
coordinates): for each leaf of the JAX package's layout
(``compression.reference_leaves``), the summed, averaged gradient of
every port leaf it stacks is all-reduced whole over its copies (an
leaf computed cut then all-gathered over the tensor axis) and its error
gathered whole from the ``err`` shards (the parameters' specs), every
rank quantizes their concatenation with ``compression.compress_stacked``
(the one-process step's code, so each rank makes the same codes), and
cuts the dequantized gradient to the optimizer state's shard and the new
error to its ``err`` shard locally. ``grad_norm`` is read from the
dequantized gradient, as in one process.

Every MoE exchange mode trains, the fused one through
``dist.collectives.dragonfly_round_trip``. Collectives of a group raise after
``launch.mesh.GROUP_TIMEOUT_S``. It launches none of K1–K5: the plain
attention (``use_kernel=False``), and the gradient sums are
``torch.distributed`` on the axis groups, on the mesh's carrier.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import time

import torch
import torch.distributed as dist
from torch.autograd.profiler import record_function

from repro_torch.dist import collectives as CL
from repro_torch.dist import sharding as SH
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


# ------------------------------------------------------------- shardings
#: Where the sharded step adds its parts' host ms while ``timing_parts`` is open.
_PARTS: dict | None = None


@contextlib.contextmanager
def timing_parts():
    """Time the parts of every sharded step made inside the block, summed
    over steps, each a host ms with the device synchronised at both ends:
    ``gather_ms`` (the leaves gathered whole), ``compute_ms`` (forward and
    backward), ``reduce_ms`` (the gradient sums and the norm) and
    ``update_ms`` (the optimizer and the parameters back to their layout).
    Synchronising changes the run: time other steps without it."""
    global _PARTS
    outer, _PARTS = _PARTS, {"steps": 0, "gather_ms": 0.0, "compute_ms": 0.0,
                             "reduce_ms": 0.0, "update_ms": 0.0}
    try:
        yield _PARTS
    finally:
        _PARTS = outer


@contextlib.contextmanager
def _part(name: str, device):
    if _PARTS is None:
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        _PARTS[name] += (time.perf_counter() - t0) * 1e3


def _reference_shape(path, shape, cfg) -> tuple:
    """The leaf's shape in the JAX package's layout: the stack's layers
    stacked over their G groups, the prefix over ``first_dense_layers``."""
    if path[0] == "stack":
        return ((cfg.n_layers - cfg.first_dense_layers) // len(cfg.layer_kinds()), *shape)
    if path[0] == "prefix":
        return (cfg.first_dense_layers, *shape)
    return tuple(shape)


def _stacked_at(path, cfg) -> int:
    """The layer's entry along the reference's stacked dim: its group in
    the stack, its index in the prefix."""
    return path[1] // len(cfg.layer_kinds()) if path[0] == "stack" else path[1]


@functools.lru_cache(maxsize=None)
def param_shapes(cfg):
    """The parameters on the meta device (shapes and dtypes, no data)."""
    return M.init_params(torch.Generator(), cfg, device="meta")


def train_shardings(cfg, rules, opt_cfg: O.OptConfig, settings: TrainSettings):
    """(param_specs, opt_specs, batch_specs, metric_specs): the reference's
    ``train_shardings`` in the port's per-layer trees (module docstring:
    a layer FSDP places whole on one data coordinate opens its spec with a
    ``Holder``)."""
    pspecs = M.param_specs(cfg, rules)
    shapes = param_shapes(cfg)

    def zero(path, spec):
        shape = _reference_shape(path, O.shape_of(O.get(shapes, path)), cfg)
        if path[0] not in O.STACKED:
            return rules._maybe_fsdp(spec, shape, zero=True)
        lead, *own = rules._maybe_fsdp((None, *spec), shape, zero=True)
        if lead is None:
            return tuple(own)
        return (SH.Holder(lead, _stacked_at(path, cfg), shape[0]), *own)

    if rules.fsdp:  # ZeRO-3: the parameters sharded over the data axes too
        pspecs = O.map_specs(pspecs, zero)
        ospecs = O.state_specs(pspecs, opt_cfg, param_shapes=shapes)
    elif rules.zero1:  # ZeRO-1: the optimizer state over the data axes; params TP-only
        ospecs = O.state_specs(O.map_specs(pspecs, zero), opt_cfg, param_shapes=shapes)
    else:
        ospecs = O.state_specs(pspecs, opt_cfg, param_shapes=shapes)
    if settings.compress_grads:
        ospecs = dict(ospecs, err=pspecs)
    bspecs = {}
    if cfg.embeds_input:
        bspecs["embeds"] = rules.activations()
    else:
        bspecs["tokens"] = rules.tokens()
    bspecs["labels"] = rules.tokens()
    if cfg.rope == "mrope":
        bspecs["mrope_positions"] = (None, rules.batch_axes, None)
    return pspecs, ospecs, bspecs, None


# ------------------------------------------------------- state on shards
def _held(x, spec, mesh):
    sl = SH.held_slices(spec, x.shape, mesh.coords, mesh.sizes)
    if sl is None:
        return None
    if x.is_meta:  # state to be made: zeros of the held slice
        return torch.zeros(x[sl].shape, dtype=x.dtype, device=mesh.device)
    return x[sl].to(mesh.device).clone()


def shard_train_state(params, opt_state, specs, mesh):
    """One-process ``(params, opt_state)`` cut to what the rank at
    ``mesh.coords`` holds under ``specs = (param_specs, opt_specs)`` (of
    ``train_shardings``), on ``mesh.device``: a leaf it holds none of is
    ``None``, and so is its state's dict. An ``opt_state`` on the meta
    device (``state_shapes``) gives a fresh state's shards, zeros, without
    ever making the whole state."""
    pspecs, ospecs = specs
    out_p = O.unflatten(params, [_held(p, O.get(pspecs, path), mesh)
                                 for path, p in O.flatten(params)])
    mu = []
    for path, _ in O.flatten(params):
        state, spec = O.get(opt_state["mu"], path), O.get(ospecs["mu"], path)
        cut = {key: _held(val, spec[key], mesh) for key, val in state.items()}
        mu.append(None if cut["m"] is None else cut)
    step = opt_state["step"]
    step = torch.zeros((), dtype=step.dtype, device=mesh.device) if step.is_meta else \
        step.to(mesh.device).clone()
    out_s = {"mu": O.unflatten(params, mu), "step": step}
    if "err" in opt_state:
        out_s["err"] = O.unflatten(params, [_held(e, O.get(ospecs["err"], path), mesh)
                                            for path, e in O.flatten(opt_state["err"])])
    return out_p, out_s


def state_shapes(cfg, opt_cfg: O.OptConfig):
    """(params, opt_state) on the meta device: every leaf's whole shape and
    dtype."""
    shapes = param_shapes(cfg)
    return shapes, O.init_state(shapes, opt_cfg)


def gather_train_state(params, opt_state, specs, like, mesh):
    """The rank's ``(params, opt_state)`` shards put back whole on every
    rank (for checks and checkpoints): ``specs`` as for
    ``shard_train_state``, ``like = state_shapes(cfg, opt_cfg)``. Every
    rank of the mesh calls it."""
    pspecs, ospecs = specs
    like_p, like_s = like
    whole = functools.partial(_regather, mesh=mesh)
    out_p = O.unflatten(like_p, [
        whole(O.get(params, path), O.get(pspecs, path), (), p) for path, p in O.flatten(like_p)])
    mu = []
    for path, _ in O.flatten(like_p):
        held, spec = O.get(opt_state["mu"], path), O.get(ospecs["mu"], path)
        mu.append({key: whole(None if held is None else held[key], spec[key], (), val)
                   for key, val in O.get(like_s["mu"], path).items()})
    out_s = {"mu": O.unflatten(like_p, mu), "step": opt_state["step"]}
    if "err" in opt_state:
        out_s["err"] = O.unflatten(like_p, [
            whole(O.get(opt_state["err"], path), O.get(ospecs["err"], path), (), _f32(p))
            for path, p in O.flatten(like_p)])
    return out_p, out_s


def _f32(like):
    """A float32 meta leaf of ``like``'s shape: the error-feedback state's."""
    return torch.empty(like.shape, dtype=torch.float32, device="meta")


def shard_batch(batch, bspecs, mesh):
    """The rank's rows of a whole batch, on ``mesh.device``."""
    return {key: x[SH.local_slices(bspecs[key], x.shape, mesh.coords, mesh.sizes)]
            .to(mesh.device) for key, x in batch.items()}


# ------------------------------------------------- moving slices between layouts
def _global(group, coord: int) -> int:
    return dist.get_global_rank(group, coord)


def _coord(axes: tuple, index: int, sizes: dict) -> dict:
    """A row-major index over ``axes`` as one coordinate an axis."""
    out = {}
    for a in reversed(axes):
        out[a] = index % sizes[a]
        index //= sizes[a]
    return out


def _entry(spec, dim):
    return spec[dim] if dim < len(spec) else None


def _lead(dims) -> int:
    """The dim a leaf travels with in front: the one dim it is gathered or
    scattered along (the carrier then moves whole rows and the device does
    the transposes), or dim 0."""
    return dims[0] if len(dims) == 1 else 0


def _front(t, lead: int, dim: int):
    """``t`` (a leaf moved ``lead`` to the front) with its ``dim`` in front."""
    at = dim + 1 if dim < lead else (0 if dim == lead else dim)
    return t.movedim(at, 0)


def _back(t, lead: int, dim: int):
    """The inverse of ``_front``."""
    at = dim + 1 if dim < lead else (0 if dim == lead else dim)
    return t.movedim(0, at)


def _regather(x, frm, to, like, mesh):
    """A leaf held under spec ``frm`` (``x``, None where this rank holds
    none) as held under ``to``, which cuts it by a subset of ``frm``'s
    entries (a ``Holder`` in ``frm`` dropped, or whole dims): all-gathers
    along the dims that ``to`` leaves whole, then a broadcast from the
    holder over its axes, on the mesh's carrier, one copy there and one
    back. ``like`` gives the whole leaf's shape and dtype. Returns the
    rank's piece under ``to`` on every rank that holds one (``x`` itself
    where nothing moves)."""
    holder, own = SH.split_holder(frm)
    to_holder, to_own = SH.split_holder(to)
    if to_holder is not None and to_holder != holder:
        raise ValueError(f"cannot move a leaf from {frm} to {to}")
    dims = []
    for dim in range(len(own)):
        axes, keep = SH.spec_axes(_entry(own, dim)), SH.spec_axes(_entry(to_own, dim))
        if keep and keep != axes:
            raise ValueError(f"cannot move a leaf from {frm} to {to}")
        if axes and not keep and any(mesh.sizes[a] > 1 for a in axes):
            dims.append(dim)
    broadcast = holder is not None and to_holder is None
    if not dims and not broadcast:
        return x
    lead = _lead(dims)
    if x is not None:
        c = mesh.to_carrier(x.movedim(lead, 0).contiguous())
        for dim in dims:
            for a in reversed(SH.spec_axes(own[dim])):  # the last axis is the fastest: first
                if mesh.sizes[a] > 1:
                    c = _back(CL._gather_cat(_front(c, lead, dim), mesh.group(a)), lead, dim)
    if broadcast:
        axes = SH.spec_axes(holder)
        src = _coord(axes, holder.index(mesh.sizes), mesh.sizes)
        if x is None:
            sl = SH.local_slices(to_own, like.shape, mesh.coords, mesh.sizes)
            shape = [len(range(*s.indices(n))) for s, n in zip(sl, like.shape)]
            shape.insert(0, shape.pop(lead))
            c = torch.empty(shape, dtype=like.dtype, device=mesh.carrier)
        c = c.contiguous()
        for a in reversed(axes):
            if mesh.sizes[a] > 1:
                g = mesh.group(a)
                dist.broadcast(c, _global(g, src[a]), group=g)
    return mesh.from_carrier(c.contiguous()).movedim(0, lead).contiguous()


def _reduce_to(g, keep, to, mesh):
    """This rank's piece under spec ``to`` of the sum of ``g`` (a leaf cut
    by ``keep``, which the call may overwrite) over the ranks that hold the
    same copy of it: those that differ only on the axes ``keep`` does not
    name. Those axes that ``to`` names reduce-scatter (a dim) or reduce to
    the holder; the rest all-reduce. The sums run on the mesh's carrier,
    one copy there and one back. None on a rank that holds nothing under
    ``to``."""
    holder, own = SH.split_holder(to)
    named = {a for d in range(len(keep)) for a in SH.spec_axes(keep[d])}
    stored = set(SH.spec_axes(holder)) | {a for e in own for a in SH.spec_axes(e)}
    dims = [dim for dim in range(len(own))
            if SH.spec_axes(own[dim]) != SH.spec_axes(_entry(keep, dim))
            and any(mesh.sizes[a] > 1 for a in SH.spec_axes(own[dim]))]
    lead = _lead(dims)
    c = mesh.to_carrier(g.movedim(lead, 0).contiguous())
    for a in mesh.axis_names:
        if a not in named and a not in stored and mesh.sizes[a] > 1:
            dist.all_reduce(c, group=mesh.group(a))
    if holder is not None:
        axes = SH.spec_axes(holder)
        dst = _coord(axes, holder.index(mesh.sizes), mesh.sizes)
        for a in axes:  # the slowest axis first: its line's sums meet on the holder's line
            if mesh.sizes[a] > 1:
                grp = mesh.group(a)
                dist.reduce(c, _global(grp, dst[a]), group=grp)
        if not holder.holds(mesh.coords, mesh.sizes):
            return None
    for dim in dims:
        for a in SH.spec_axes(own[dim]):  # the slowest axis first: it splits into the largest blocks
            if mesh.sizes[a] > 1:
                c = _back(CL._reduce_scatter_rows(_front(c, lead, dim).contiguous(),
                                                  mesh.group(a), inplace=True), lead, dim)
    return mesh.from_carrier(c.contiguous()).movedim(0, lead).contiguous()


def _subslice(outer: tuple, inner: tuple) -> tuple:
    """``inner`` (slices of the whole leaf) within the piece ``outer`` cuts."""
    return tuple(slice(i.start - o.start, i.stop - o.start) if i.start is not None
                 and o.start is not None else i for o, i in zip(outer, inner))


def _replica(spec, mesh) -> bool:
    """Whether this rank's piece under ``spec`` is a copy that another rank
    with a lower coordinate on an axis the spec does not name also holds."""
    named = {a for e in spec for a in SH.spec_axes(e)}
    return any(mesh.coords[a] for a in mesh.axis_names if a not in named)


def _seed(mesh) -> float:
    """Each rank's share of the backward's seed: its loss copy counts
    ``1 / n_ranks`` of the global loss."""
    return 1.0 / math.prod(mesh.shape)


def _missing_grad(path, batch, leaf):
    """A leaf the loss did not reach: zeros for the ``embed`` table when
    the batch holds ``embeds`` (the loss reads embeddings there), and an
    error for any other."""
    if path == ("embed", "table") and "embeds" in batch:
        return torch.zeros(leaf.shape, dtype=torch.float32, device=leaf.device)
    raise RuntimeError(f"no gradient reached {'/'.join(map(str, path))}: a collective on the "
                       "path has no backward, or the leaf is not used")


def _batch_rows(batch, bspecs, mesh, mb_n: int):
    """The rank's rows of each microbatch: microbatch i is rows block i of
    the global batch (the reference's split), cut as ``bspecs`` cuts a
    batch. With one microbatch, the rank's own rows. A microbatch with
    fewer rows than the batch axes have coordinates (16 rows over pod·data
    = 32) gives each row to that many coordinates in turn: every row
    counts equally often, so the mean loss is the global one."""
    if mb_n == 1:
        return [batch]
    whole = {}
    for key, x in batch.items():
        dim = 1 if key == "mrope_positions" else 0
        axes = SH.spec_axes(_entry(bspecs[key], dim))
        for a in reversed(axes):
            if mesh.sizes[a] > 1:
                x = CL.all_gather(x.movedim(dim, 0), mesh.group(a), mesh=mesh).movedim(0, dim)
        whole[key] = x
    return [_microbatch_rows(mb, bspecs, mesh) for mb in split_microbatches(whole, mb_n)]


def _microbatch_rows(mb, bspecs, mesh):
    """The rank's rows of one whole microbatch: ``shard_batch`` where its
    rows split over the batch axes, else (fewer rows than coordinates, a
    whole number of coordinates a row) row ``b // (n / rows)`` of batch
    coordinate b of n."""
    out = {}
    for key, x in mb.items():
        dim = 1 if key == "mrope_positions" else 0
        axes = SH.spec_axes(_entry(bspecs[key], dim))
        n = math.prod(mesh.sizes[a] for a in axes)
        rows = x.shape[dim]
        if rows % n == 0:
            out[key] = shard_batch({key: x}, bspecs, mesh)[key]
            continue
        if n % rows:
            raise ValueError(f"a microbatch of {rows} rows neither splits over nor repeats "
                             f"evenly on the batch axes {axes} ({n})")
        b = 0
        for a in axes:
            b = b * mesh.sizes[a] + mesh.coords[a]
        row = b // (n // rows)
        out[key] = x.narrow(dim, row, 1).to(mesh.device)
    return out


def _global_metrics(metrics, rules, mesh):
    """The mean over the batch axes of each scalar (every rank of a model
    group holds the same values), as one all-reduce a batch axis."""
    keys = sorted(metrics)
    v = torch.stack([metrics[k].float().reshape(()) for k in keys])
    n = 1
    for a in SH.spec_axes(rules.batch_axes):
        if mesh.sizes.get(a, 1) > 1:
            v = CL.all_reduce_sum(v, mesh.group(a), mesh=mesh)
            n *= mesh.sizes[a]
    return {k: v[i] / n for i, k in enumerate(keys)}


def _compress(g_sum, err, mb_n, paths, keep, pspecs, mspecs, like_p, period, mesh):
    """``compress_grads`` on the mesh (module docstring), a JAX leaf at a
    time: ``g_sum`` this rank's gradient of each leaf of ``paths`` under its
    compute spec ``keep[path]`` (the call empties it), ``err`` the rank's
    error-feedback shards under ``pspecs``. Returns (the codes by JAX path,
    the same on every rank; {path: the dequantized gradient's piece under
    ``mspecs[path]`` in the gradient's dtype, or None}, {path: the new
    error's piece under the parameter's spec, or None})."""
    index = {path: i for i, path in enumerate(paths)}
    codes, grads, new_err = {}, {}, {}
    for ref_path, group in C.reference_leaves(like_p, period):
        g_whole, e_whole = [], []
        for path in group:
            i, like = index[path], O.get(like_p, path)
            g, g_sum[i] = g_sum[i], None
            g = _reduce_to(g / mb_n if mb_n > 1 else g, keep[path], (None,) * like.ndim, mesh)
            g_whole.append(_regather(g, keep[path], (), like, mesh))
            e_whole.append(_regather(O.get(err, path), O.get(pspecs, path), (), _f32(like), mesh))
        codes[ref_path], deq, errs = C.compress_stacked(g_whole, e_whole)
        for path, d, e in zip(group, deq, errs):
            shape = O.get(like_p, path).shape
            cut = SH.held_slices(mspecs[path], shape, mesh.coords, mesh.sizes)
            grads[path] = None if cut is None else d[cut].clone()
            cut = SH.held_slices(O.get(pspecs, path), shape, mesh.coords, mesh.sizes)
            new_err[path] = None if cut is None else e[cut].clone()
    return codes, grads, new_err


def make_sharded_train_step(cfg, opt_cfg: O.OptConfig, settings: TrainSettings):
    """-> step(params, opt_state, batch) -> (params, opt_state, metrics) on
    this rank's shards (module docstring), under the rules and mesh that
    ``dist.sharding.set_active`` registered; ``batch`` is the rank's rows
    (``shard_batch``). Every rank of the mesh calls it together."""
    like_p, _ = state_shapes(cfg, opt_cfg)
    period = len(cfg.layer_kinds())

    def step(params, opt_state, batch):
        act = SH.active()
        if act is None:
            raise RuntimeError("the sharded train step needs active sharding rules and a mesh: "
                               "dist.sharding.set_active(rules, mesh)")
        rules, mesh = act
        pspecs, ospecs, bspecs, _ = train_shardings(cfg, rules, opt_cfg, settings)
        paths = [path for path, _ in O.flatten(like_p)]
        cspecs = M.compute_specs(cfg, rules)  # each leaf's spec in compute
        keep = {path: O.get(cspecs, path) for path in paths}
        if _PARTS is not None:
            _PARTS["steps"] += 1
        with torch.no_grad(), _part("gather_ms", mesh.device):
            full = [_regather(O.get(params, path), O.get(pspecs, path), keep[path],
                              O.get(like_p, path), mesh) for path in paths]
        leaves = [x.detach().requires_grad_(True) for x in full]
        tree = O.unflatten(like_p, leaves)
        g_sum, loss_sum, metrics = None, 0.0, None
        mbs = _batch_rows(batch, bspecs, mesh, settings.microbatches)
        for mb in mbs:
            with _part("compute_ms", mesh.device), record_function("train.forward"):
                loss, metrics = M.loss_fn(tree, mb, cfg, use_kernel=settings.use_kernel,
                                          remat=settings.remat)
            with _part("compute_ms", mesh.device), record_function("train.backward"):
                grads = torch.autograd.grad(loss, leaves, torch.full_like(loss, _seed(mesh)),
                                            allow_unused=True)
            grads = [(_missing_grad(path, mb, x) if g is None else g)
                     for path, x, g in zip(paths, leaves, grads)]
            if len(mbs) > 1:  # summed in float32; one microbatch's stay in their dtypes
                grads = [g.float() for g in grads]
            g_sum = grads if g_sum is None else [a + b for a, b in zip(g_sum, grads)]
            loss_sum = loss_sum + loss.detach()
            del grads
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss_sum / len(mbs)
        del leaves, tree, full
        with torch.no_grad():
            return _sharded_update(params, opt_state, g_sum, len(mbs), metrics, paths, keep,
                                   pspecs, ospecs, like_p, rules, mesh)

    def _sharded_update(params, opt_state, g_sum, mb_n, metrics, paths, keep, pspecs, ospecs,
                        like_p, rules, mesh):
        mspecs = {path: O.get(ospecs["mu"], path)["m"] for path in paths}
        with record_function("train.optimizer"), _part("reduce_ms", mesh.device):
            if settings.compress_grads:
                _, reduced, new_err = _compress(g_sum, opt_state["err"], mb_n, paths, keep,
                                                pspecs, mspecs, like_p, period, mesh)
            else:
                reduced = {}
                for i, path in enumerate(paths):
                    g, g_sum[i] = g_sum[i], None  # a leaf at a time
                    reduced[path] = _reduce_to(g / mb_n if mb_n > 1 else g, keep[path],
                                               mspecs[path], mesh)
            grads, p_opt, sq = [], [], torch.zeros((), dtype=torch.float32, device=mesh.device)
            for path in paths:
                g = reduced.pop(path)
                mspec = mspecs[path]
                g = None if g is None else g.float()
                grads.append(g)
                p = O.get(params, path)
                if g is None:
                    p_opt.append(None)
                    continue
                if not _replica(mspec, mesh):
                    sq = sq + torch.sum(torch.square(g))
                whole = O.get(like_p, path).shape
                outer = SH.held_slices(O.get(pspecs, path), whole, mesh.coords, mesh.sizes)
                inner = SH.held_slices(mspec, whole, mesh.coords, mesh.sizes)
                p_opt.append(p[_subslice(outer, inner)])
            gnorm = torch.sqrt(CL.all_reduce_sum(sq.reshape(1), dist.group.WORLD,
                                                 mesh=mesh)[0])
        with record_function("train.optimizer"), _part("update_ms", mesh.device):

            def mean(path, x, dim, param_dim):
                _, own = SH.split_holder(O.get(ospecs["mu"], path)["m"])
                total = x.sum(dim)
                for a in SH.spec_axes(_entry(own, len(O.get(like_p, path).shape) + param_dim)):
                    if mesh.sizes[a] > 1:
                        total = CL.all_reduce_sum(total, mesh.group(a), mesh=mesh)
                return total / O.get(like_p, path).shape[param_dim]

            new_p, new_s, opt_metrics = O.apply_updates(
                O.unflatten(like_p, p_opt), O.unflatten(like_p, grads), opt_state, opt_cfg,
                gnorm=gnorm, mean=mean)
            if settings.compress_grads:
                new_s["err"] = O.unflatten(like_p, [new_err[path] for path in paths])
            out = [_regather(O.get(new_p, path), mspecs[path],
                             O.get(pspecs, path), O.get(like_p, path), mesh) for path in paths]
        metrics = _global_metrics(metrics, rules, mesh)
        metrics.update(opt_metrics)
        return O.unflatten(like_p, out), new_s, metrics

    return step
