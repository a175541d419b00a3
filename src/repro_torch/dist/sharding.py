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

Launchers call ``set_active(rules, mesh)`` so model code (the MoE
dispatch) can fetch the live rules without threading them through every
call; with none active, everything runs on one device. The port's mesh is
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
    seq_parallel: bool = False
    # "xla" (the native all-to-all) | "dragonfly" (§3 program on
    # torch_dist) | "dragonfly_overlap" (same program, start_step order)
    # | "dragonfly_overlap_fused" (dispatch + expert FFN + combine as ONE
    #   wave pipeline) | "auto" (the autotuner's pick; not ported yet)
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


def local_slices(spec: Spec, shape, coords: dict, sizes: dict) -> tuple[slice, ...]:
    """The slices of a ``shape`` array that the rank at ``coords`` (axis ->
    coordinate) holds under ``spec`` on a mesh of ``sizes`` (axis -> size).
    A dim sharded over several axes splits row-major over them, the first
    axis slowest, as a ``PartitionSpec`` entry of a tuple does."""
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
