"""Sharding rule-set and the process-wide active (rules, mesh) registration.

The port of ``repro.dist.sharding``. ``ShardRules`` names the axes and
builds the spec of every parameter and activation: tensor-parallel
projections (Megatron column/row split over the ``model`` axis), token and
batch sharding over the data axes, and the MoE expert placement
(expert-parallel where E divides the model axis, TP-experts otherwise).
There is no ``PartitionSpec`` in torch, so a spec is a plain tuple with
one entry per dim: an axis name, a tuple of axis names, or None.
``local_slices`` turns a spec into the slices a rank holds, from its
coordinates on the mesh.

A per-layer spec may also open with a ``Holder``, one entry more than the
layer has dims: the layer lies whole (as the rest of the spec cuts it) on
one coordinate of the batch axes and nowhere else. It is what FSDP gives
a layer of the stack where the JAX package's ``_maybe_fsdp`` shards the
stacked group dim (``train.train_step.train_shardings``): the reference's
stacked spec with its leading entry replaced by the data coordinate that
holds this layer. ``held_slices`` answers, for any rank, which slices of
such a leaf it holds, or None.

Launchers call ``set_active(rules, mesh)`` so model code (the MoE
dispatch, the tensor-parallel train path through
``dist.collectives.tensor_parallel``) can fetch the live rules without
threading them through every call; with none active, everything runs on
one device. The port's mesh is
this rank's process-group mesh (``launch.mesh.ProcessMesh``): its
``axis_names``, ``shape``, this rank's coordinate on each axis and the
process group of each axis.

Not ported: ``constrain``. It is a GSPMD sharding constraint on a global
array inside a trace, and an eager per-rank program has no such thing:
each rank holds its shard and the collectives are explicit.
"""

from __future__ import annotations

import dataclasses
import math

#: a spec: one entry per dim, an axis name, a tuple of axis names, or None
Spec = tuple


@dataclasses.dataclass(frozen=True)
class ShardRules:
    """Axis names and the spec methods derived from them.

    Spec methods take the parameter's shape tuple (dims may be dummy 0s:
    specs do not depend on the sizes)."""

    tensor_axis: str = "model"
    data_axis: str = "data"
    pod_axis: str | None = None
    fsdp: bool = False
    zero1: bool = False
    seq_parallel: bool = False  # the residual stream cut along the sequence (member_train)
    # "xla" (the native all-to-all) | "dragonfly" (§3 program on
    # torch_dist) | "dragonfly_overlap" (same program, start_step order)
    # | "dragonfly_overlap_fused" (dispatch + expert FFN + combine as ONE
    #   wave pipeline) | "auto" (the autotuner's pick, resolved once per
    #   key before any exchange and agreed by every rank of the mesh)
    moe_collectives: str = "xla"
    model_axis_size: int = 16
    data_axis_size: int = 16

    # ------------------------------------------------------------- axes
    @property
    def batch_axes(self):
        if self.pod_axis:
            return (self.pod_axis, self.data_axis)
        return self.data_axis

    # ------------------------------------------------------ activations
    def tokens(self) -> Spec:
        """(B·S,) or (B, S) token ids: sharded over the batch axes."""
        return (self.batch_axes, None)

    def activations(self) -> Spec:
        """(B, S, d) activations: batch over data axes, d replicated."""
        return (self.batch_axes, None, None)

    # ----------------------------------------------------- dense params
    def attn_in(self, shape) -> Spec:
        """Column-parallel input projection (d, heads·hd): shard dim 1."""
        return (None, self.tensor_axis)

    def attn_out(self, shape) -> Spec:
        """Row-parallel output projection (heads·hd, d): shard dim 0."""
        return (self.tensor_axis, None)

    def mlp_in(self, shape) -> Spec:
        return (None, self.tensor_axis)

    def mlp_out(self, shape) -> Spec:
        return (self.tensor_axis, None)

    def embed(self, shape) -> Spec:
        """(vocab, d) table: shard the model dim (gather-free lookup)."""
        return (None, self.tensor_axis)

    # ------------------------------------------------------------- MoE
    def expert_parallel(self, n_experts: int) -> bool:
        return n_experts % self.model_axis_size == 0

    def expert(self, shape, ff_dim: int | None = None, n_experts: int | None = None) -> Spec:
        """Per-expert stacked weights (E, ..., ...).

        Expert-parallel (E divides the model axis): shard the expert dim,
        so each model shard owns E/n_model experts outright and dispatch is
        the §3 all-to-all. TP fallback: experts replicated, their ff dim
        sharded over the tensor axis."""
        ndim = len(shape)
        if n_experts is not None and self.expert_parallel(n_experts):
            return (self.tensor_axis, *([None] * (ndim - 1)))
        axes: list = [None] * ndim
        axes[ff_dim if ff_dim is not None else ndim - 1] = self.tensor_axis
        return tuple(axes)

    # ------------------------------------------------------------ FSDP
    def _maybe_fsdp(self, spec: Spec, shape, zero: bool = False) -> Spec:
        """Additionally shard the first spec-free dim divisible by the data
        axis over the batch axes (ZeRO-1/3 partitioning)."""
        if not (self.fsdp or zero):
            return spec
        axes = list(spec) + [None] * (len(shape) - len(spec))
        for i, (ax, dim) in enumerate(zip(axes, shape)):
            if ax is None and dim and dim % self.data_axis_size == 0:
                axes[i] = self.batch_axes
                return tuple(axes)
        return spec


@dataclasses.dataclass(frozen=True)
class Holder:
    """The leading entry of a per-layer spec whose layer one coordinate of
    ``axes`` (the batch axes: a name or a tuple, row-major, the first axis
    slowest) holds whole. The layer is entry ``at`` of the JAX package's
    stacked dim of ``of`` entries (group g of the stack's G groups, or
    prefix layer i of ``first_dense_layers``), which the batch axes split
    into equal runs: coordinate ``at // (of / n)`` holds it, n the
    product of the batch axes' sizes."""

    axes: str | tuple
    at: int
    of: int

    def index(self, sizes: dict) -> int:
        """The batch coordinate (row-major over ``axes``) that holds the layer."""
        parts = math.prod(sizes[a] for a in spec_axes(self))
        if self.of % parts:
            raise ValueError(f"a stacked dim of {self.of} does not split over "
                             f"{spec_axes(self)} ({parts})")
        return self.at // (self.of // parts)

    def holds(self, coords: dict, sizes: dict) -> bool:
        at = 0
        for a in spec_axes(self):
            at = at * sizes[a] + coords[a]
        return at == self.index(sizes)


def spec_axes(entry) -> tuple:
    """The mesh axes a spec entry names (a ``Holder``'s included)."""
    if entry is None:
        return ()
    if isinstance(entry, Holder):
        entry = entry.axes
    return entry if isinstance(entry, tuple) else (entry,)


def split_holder(spec: Spec) -> tuple[Holder | None, Spec]:
    """(the spec's ``Holder`` or None, the spec of the leaf's own dims)."""
    if spec and isinstance(spec[0], Holder):
        return spec[0], tuple(spec[1:])
    return None, tuple(spec)


def held_slices(spec: Spec, shape, coords: dict, sizes: dict) -> tuple[slice, ...] | None:
    """The slices of a ``shape`` leaf that the rank at ``coords`` holds
    under ``spec`` (a ``Holder`` allowed), or None where it holds none."""
    holder, own = split_holder(spec)
    if holder is not None and not holder.holds(coords, sizes):
        return None
    return local_slices(own, shape, coords, sizes)


def local_slices(spec: Spec, shape, coords: dict, sizes: dict) -> tuple[slice, ...]:
    """The slices of a ``shape`` array that the rank at ``coords`` (axis ->
    coordinate) holds under ``spec`` on a mesh of ``sizes`` (axis -> size).
    A dim sharded over several axes splits row-major over them, the first
    axis slowest, as a ``PartitionSpec`` entry of a tuple does. A spec
    that opens with a ``Holder`` goes through ``held_slices``."""
    if spec and isinstance(spec[0], Holder):
        raise ValueError("a spec with a Holder may hold nothing on this rank: use held_slices")
    out = []
    for i, dim in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        if ax is None:
            out.append(slice(None))
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        parts = math.prod(sizes[a] for a in axes)
        if dim % parts:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split over {axes} ({parts})")
        index = 0
        for a in axes:
            index = index * sizes[a] + coords[a]
        step = dim // parts
        out.append(slice(index * step, (index + 1) * step))
    return tuple(out)


# --------------------------------------------------------------------------
# Active-rules registry (set by launchers, read by model internals).
# --------------------------------------------------------------------------

_ACTIVE: tuple[ShardRules, object] | None = None


def set_active(rules: ShardRules, mesh) -> None:
    """Register the live (rules, mesh); axis sizes are re-derived from the
    mesh so rule defaults never lie about the actual layout."""
    global _ACTIVE
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    repl = {}
    if rules.tensor_axis in sizes:
        repl["model_axis_size"] = sizes[rules.tensor_axis]
    if rules.data_axis in sizes:
        repl["data_axis_size"] = sizes[rules.data_axis]
    if repl:
        rules = dataclasses.replace(rules, **repl)
    _ACTIVE = (rules, mesh)


def clear_active() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> tuple[ShardRules, object] | None:
    return _ACTIVE
