"""The paper's four algorithms as cached programs and as per-shard
collectives over ``torch.distributed``.

Each ``*_program`` getter emits the §2–§5 schedule from its core algorithm
module as a ``Schedule``, lowers it once per layout with
``runtime.lowering.lower`` into a backend-neutral ``CollectiveProgram``
(cached — lowering is pure Python) and, with ``optimized=True``, returns
the ``runtime.optimize`` fused-table form instead. Whole-array callers hand
either form to a backend's ``run_*``:

    from repro_torch.dist.collectives import allreduce_program
    from repro_torch.dist.mesh import dragonfly_layout
    from repro_torch.runtime.backends import get_backend

    prog = allreduce_program(dragonfly_layout(64), optimized=True)
    y = get_backend("cuda_fused").run_allreduce(x, prog)

Each ``dragonfly_*`` entry point runs the program per shard: it is called
on every rank of a process group of ``program.n`` ranks (rank i = router
``layout.topo.id_router(i)``, ``launch.mesh.make_dragonfly_group``) with
that rank's shard, and a runtime backend (default: ``torch_dist``, one
``batch_isend_irecv`` per stage) replays the stages. Pass ``backend`` to
retarget (e.g. ``TorchDistBackend(overlap=True)`` for cross-round overlap
on pipelined schedules).

Every entry point also takes an optional Property-2 ``embedding``
(``DeviceLayout.embed_onto``): the lowered guest program is then rewritten
through ``runtime.rewrite.emulate`` onto the embedding's host, so a
guest-sized collective runs on the HOST group (``embedding.host`` routers)
with non-participating ranks idle — the §2 matmul and §3 all-to-all of a
D3(J,L) workload on a D3(K,M) group without re-deriving anything.
Rewrites are cached alongside the native programs.

The per-shard ``dragonfly_*`` entry points replay stages and therefore
take ordinary programs; the getters' ``optimized=True`` form is for the
whole-array ``run_*``.

Multi-tenancy: ``concurrent_program(kind, embeddings)`` merges the guest
programs of N pairwise-disjoint embeddings (``core.emulation.
disjoint_embeddings``) into ONE host program through ``runtime.combine``,
so N tenants' collectives run in max(T_i) rounds instead of Σ T_i;
``concurrent_programs`` builds the whole suite at once. Per-guest inputs
and results move through ``runtime.combine.scatter_guests`` /
``gather_guests``.

``device_trace(program)`` exports any of these programs as its validated
per-device send/recv trace (``runtime.export``).

Under autograd, ``native_all_to_all``, ``dragonfly_all_to_all``,
``all_gather`` and ``all_reduce_sum`` have their SPMD transposes as
backwards (an equal-split all-to-all is its own adjoint; an all-gather's
is the rank's block of the summed cotangents; a sum's is the same sum),
on the ``mesh``'s carrier where one is given: the MoE layers' exchanges
and sums in the sharded train step (``train.train_step``).
``dragonfly_round_trip`` differentiates the fused round trip: its
backward replays the same wave pipeline on the cotangent, each wave's
compute the VJP of the forward's at that wave's arrivals.

``TensorParallel`` is the tensor axis as the dense layers compute on it;
``lse_combine`` joins the ranks' partial attentions over their blocks of
a sequence-sharded cache by their log-sum-exp (the decode's split-KV);
``fetch_columns`` gives each rank the columns it wants of a last dim cut
contiguously over the axis, one all-to-all whose backward is the reverse
one: its channels of every part of a leaf whose parts lie side by side
(``part_wants``: Mamba's ``[x | z]``, the sLSTM's ``[i | f | z | o]``),
or the mLSTM's ``[x | gate]`` columns of the heads it computes.
"""

from __future__ import annotations

import copy
import functools

import torch
import torch.distributed as dist

from repro_torch.core import alltoall as a2a
from repro_torch.core import broadcast as bc
from repro_torch.core import hypercube as hc
from repro_torch.core import matmul as mm
from repro_torch.core.emulation import Embedding
from repro_torch.core.topology import D3
from repro_torch.dist.mesh import DeviceLayout
from repro_torch.runtime import lowering
from repro_torch.runtime.backends.torch_dist import TorchDistBackend
from repro_torch.runtime.optimize import optimize
from repro_torch.runtime.program import CollectiveProgram
from repro_torch.runtime.rewrite import emulate

_DEFAULT_BACKEND = TorchDistBackend()


def _resolve_backend(backend):
    """None -> the default ``torch_dist`` backend; a string -> the
    registered backend of that name; anything else is taken to already be a
    backend instance."""
    if backend is None:
        return _DEFAULT_BACKEND
    if isinstance(backend, str):
        from repro_torch.runtime.backends import get_backend

        return get_backend(backend)
    return backend


def _emulated(prog: CollectiveProgram, guest: D3, embedding: Embedding | None):
    """Rewrite ``prog`` onto the embedding's host (no-op without one).
    ``emulate`` is itself lru-cached on (program, embedding), so the rewrite
    cost is paid once per (host, guest, c_set, p_set, program) key."""
    if embedding is None:
        return prog
    if embedding.guest != guest:
        raise ValueError(
            f"embedding guest D3({embedding.guest.K},{embedding.guest.M}) "
            f"does not match the program's D3({guest.K},{guest.M})"
        )
    return emulate(prog, embedding)


# ----------------------------------------------------------- cached lowering
@functools.lru_cache(maxsize=None)
def alltoall_program(
    layout: DeviceLayout, embedding: Embedding | None = None,
    *, optimized: bool = False, pipelined: int = 0,
) -> CollectiveProgram:
    """``pipelined=0`` lowers the barrier §3 schedule (every stage stamped
    start_step 0). ``pipelined=offset >= 1`` lowers the Schedule-``offset``
    pipelined variant instead: stages carry the measured ``round_starts``
    launch stamps, which is what gives the overlapped executors
    (``overlap``/``overlap_fused`` replay, ``alltoall_compute``) real waves
    to interleave."""
    sched = (a2a.pipelined_schedule(layout.da_params, pipelined, layout.topo)
             if pipelined else a2a.schedule(layout.da_params, layout.topo))
    prog = lowering.lower(sched)
    prog = _emulated(prog, layout.topo, embedding)
    return optimize(prog) if optimized else prog


@functools.lru_cache(maxsize=None)
def allreduce_program(
    layout: DeviceLayout, embedding: Embedding | None = None,
    *, optimized: bool = False,
) -> CollectiveProgram:
    sbh = layout.sbh
    if sbh is None:
        raise ValueError(
            f"D3({layout.topo.K},{layout.topo.M}) is not a power-of-two SBH; "
            "no hypercube all-reduce schedule exists"
        )
    prog = lowering.lower(hc.allreduce_schedule(sbh))
    prog = _emulated(prog, layout.topo, embedding)
    return optimize(prog) if optimized else prog


@functools.lru_cache(maxsize=None)
def broadcast_program(
    layout: DeviceLayout, root: int, embedding: Embedding | None = None,
    *, optimized: bool = False,
) -> CollectiveProgram:
    prog = lowering.lower(
        bc.depth3_schedule(layout.topo, layout.topo.id_router(root))
    )
    prog = _emulated(prog, layout.topo, embedding)
    return optimize(prog) if optimized else prog


@functools.lru_cache(maxsize=None)
def matmul_program(
    K: int, M: int, embedding: Embedding | None = None,
    *, optimized: bool = False,
) -> CollectiveProgram:
    """§2 program for the K×K array of M×M blocks (K²M² devices); with an
    embedding, the guest D3(K², M) program rewritten onto its host."""
    g = mm.MatmulGrid(K, M)
    prog = _emulated(lowering.lower(mm.schedule(g)), g.topo, embedding)
    return optimize(prog) if optimized else prog


# -------------------------------------------------- concurrent guests
@functools.lru_cache(maxsize=None)
def concurrent_program(
    kind: str, embeddings: tuple[Embedding, ...],
    *, roots: tuple[int, ...] | None = None, optimized: bool = False,
    pipelined: int = 0,
) -> CollectiveProgram:
    """One combined host program multiplexing every embedding's guest
    ``kind`` collective (``runtime.combine.combine`` of the cached
    per-guest rewrites). ``roots`` gives each broadcast guest its own
    root (guest device ids, default 0). ``optimized=True`` returns the
    fused-table form — the stacked-σ tables then span all guests.
    ``pipelined`` (alltoall guests only) combines each guest's
    Schedule-``offset`` pipelined variant, so the combined program's stages
    keep real launch stamps for the overlapped executors — this is the form
    the multi-tenant serving fleet replays at every MoE boundary."""
    from repro_torch.runtime.combine import combine

    if roots is not None and len(roots) != len(embeddings):
        raise ValueError(f"{len(roots)} roots for {len(embeddings)} guests")
    guests: list[CollectiveProgram] = []
    for gi, emb in enumerate(embeddings):
        layout = DeviceLayout(emb.guest)
        if kind == "alltoall":
            guests.append(alltoall_program(layout, emb, pipelined=pipelined))
        elif kind == "allreduce":
            guests.append(allreduce_program(layout, emb))
        elif kind == "broadcast":
            root = roots[gi] if roots is not None else 0
            guests.append(broadcast_program(layout, root, emb))
        elif kind == "matmul":
            k = int(round(emb.guest.K ** 0.5))
            if k * k != emb.guest.K:
                raise ValueError(
                    f"guest {gi} D3({emb.guest.K},{emb.guest.M}) is not a "
                    "§2 grid (K must be a perfect square)"
                )
            guests.append(matmul_program(k, emb.guest.M, emb))
        else:
            raise ValueError(f"unknown program kind {kind!r}")
    prog = combine(guests)
    return optimize(prog) if optimized else prog


def _kind_supported(kind: str, emb: Embedding) -> bool:
    """Structural capability check: can this guest SHAPE emit ``kind``?
    (Mirrors the skips in ``train.fault_tolerance.lower_layout_programs``;
    kept structural so genuine errors — overlapping images, mismatched
    hosts — still propagate out of ``concurrent_programs``.)"""
    if kind == "allreduce":
        sbh = DeviceLayout(emb.guest).sbh
        return sbh is not None and sbh.dims > 0  # no cube on 1 router
    if kind == "matmul":
        k = int(round(emb.guest.K ** 0.5))
        return k * k == emb.guest.K
    return kind in ("alltoall", "broadcast")


def concurrent_programs(
    embeddings: tuple[Embedding, ...], kinds=("alltoall", "allreduce",
                                              "broadcast"),
    *, roots=None, optimized: bool = False,
) -> dict[str, CollectiveProgram]:
    """The combined-program suite for one tenant set: {kind: program} for
    every requested kind all guest SHAPES support (e.g. allreduce off
    powers of two is skipped). Anything else — overlapping images,
    mismatched hosts, bad roots — raises rather than thinning the suite."""
    if roots is not None and len(roots) != len(embeddings):
        raise ValueError(f"{len(roots)} roots for {len(embeddings)} guests")
    out: dict[str, CollectiveProgram] = {}
    for kind in kinds:
        if not all(_kind_supported(kind, e) for e in embeddings):
            continue
        if kind == "matmul" and len({e.guest for e in embeddings}) > 1:
            # individually capable but differently-shaped guests cannot
            # share one local-contract skeleton — skip, don't crash
            continue
        out[kind] = concurrent_program(
            kind, tuple(embeddings),
            roots=None if roots is None else tuple(roots),
            optimized=optimized,
        )
    return out


# ----------------------------------------------------------- trace export
def device_trace(program):
    """The versioned per-device send/recv op trace of any program the
    getters above return (``runtime.export``), statically validated for
    link-conflict-freedom and send/recv pairing — the form another
    runtime consumes, and what ``backend="sendrecv"`` replays. Memoized
    per program; accepts the ``optimized=True`` fused form too (same
    trace as its source)."""
    from repro_torch.runtime.backends.sendrecv import SendRecvBackend

    return SendRecvBackend.trace(program)


# ------------------------------------------------------------- collectives
class _Collective(torch.autograd.Function):
    """A collective under autograd: ``forward(x)`` in the forward and
    ``backward(g)``, its SPMD transpose, on the cotangent; both on the
    ``mesh``'s carrier where one is given (moved there and back by
    ``ProcessMesh.to_carrier`` and ``from_carrier``, counted). Without
    grad it is ``forward`` on the carrier and nothing more."""

    @staticmethod
    def forward(ctx, x, forward, backward, mesh):
        ctx.backward_fn, ctx.mesh = backward, mesh
        return _on_carrier(forward, x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _on_carrier(ctx.backward_fn, g.contiguous(), ctx.mesh), None, None, None


def _on_carrier(fn, x, mesh):
    if mesh is None:
        return fn(x)
    return mesh.from_carrier(fn(mesh.to_carrier(x)))


def _native_exchange(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def native_all_to_all(x: torch.Tensor, group=None, mesh=None) -> torch.Tensor:
    """Reference: ``torch.distributed``'s own all-to-all, same (n, ...)
    chunk layout (x[j] goes to rank j; out[j] came from rank j). Under
    autograd its backward is the same exchange of the cotangent (an
    equal-split all-to-all is its own adjoint). With a ``mesh`` the
    payload travels on its carrier both ways."""
    def exchange(t):
        return _native_exchange(t, group)

    return _Collective.apply(x, exchange, exchange, mesh)


def dragonfly_all_to_all(x, group, layout: DeviceLayout, backend=None,
                         embedding: Embedding | None = None, mesh=None):
    """§3 doubly-parallel all-to-all: K·M²/s rounds of s exchanges.

    ``x``: (n, ...) with x[j] = chunk for rank j; returns (n, ...) with
    out[j] = chunk from rank j (``native_all_to_all``'s layout). With an
    ``embedding``, ``layout`` is the guest and the exchange runs on the
    host group (n = host routers); idle ranks pass zeros through. Under
    autograd its backward replays the same program on the cotangent;
    with a ``mesh`` the payload travels on its carrier both ways."""
    be = _resolve_backend(backend)
    pipelined = 1 if getattr(be, "overlap_fused", False) else 0
    prog = alltoall_program(layout, embedding, pipelined=pipelined)

    def exchange(t):
        return be.alltoall(t, group, prog)

    return _Collective.apply(x, exchange, exchange, mesh)


def _gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def _reduce_scatter_rows(g: torch.Tensor, group, inplace: bool = False) -> torch.Tensor:
    """This rank's block of rows of the sum of every rank's ``g``: the
    all-gather's transpose, one ``reduce`` of each block to its rank (half
    an all-reduce's bytes). ``inplace`` lets it write into ``g``."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    blocks = (g if inplace else g.clone()).chunk(n)
    for j, block in enumerate(blocks):
        dist.reduce(block, dist.get_global_rank(group, j), group=group)
    return blocks[r]


def _gather_transpose(g: torch.Tensor, group) -> torch.Tensor:
    """``all_gather``'s backward, by name, so that a check can plant a
    fault in it."""
    return _reduce_scatter_rows(g, group)


def all_gather(x: torch.Tensor, group, mesh=None) -> torch.Tensor:
    """Every rank's ``x`` of the group, concatenated along dim 0 in group
    rank order. Under autograd the backward is its SPMD transpose: the
    rank's block of the cotangents summed over the group (every rank's
    copy of the output contributes). With a ``mesh``, on its carrier."""
    return _Collective.apply(x, lambda t: _gather_cat(t, group),
                             lambda g: _gather_transpose(g, group), mesh)


def all_reduce_sum(x: torch.Tensor, group=None, mesh=None) -> torch.Tensor:
    """The sum of every rank's ``x`` over the group, as a new tensor (the
    input is not written). Under autograd its backward is the same sum of
    the cotangents. With a ``mesh``, on its carrier."""
    def total(t):
        return _sum(t, group)

    return _Collective.apply(x, total, total, mesh)


# ---------------------------------------------- the tensor axis' pairs
def _wide(dtype: torch.dtype) -> torch.dtype:
    """The dtype a sum of ``dtype`` values is added in: float32 at least."""
    return torch.promote_types(dtype, torch.float32)


def _f32_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of ``x``, added in float32 (or wider) and cast back."""
    return _sum(x.to(_wide(x.dtype)), group).to(x.dtype)


def tp_sum(x: torch.Tensor, group, mesh=None) -> torch.Tensor:
    """The output of a row-parallel block: the sum of the ranks' partials
    over the tensor group, added in float32 and cast back to ``x``'s
    dtype. Under autograd its backward is the same sum of the cotangents
    (its SPMD transpose). With a ``mesh``, on its carrier."""
    if dist.get_world_size(group) == 1:
        return x

    def total(t):
        return _f32_sum(t, group)

    return _Collective.apply(x, total, total, mesh)


def _gather_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _gather_cat(x.movedim(dim, 0), group).movedim(0, dim)


def _scatter_sum_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of the group's sum, added in float32
    (or wider)."""
    rows = x.movedim(dim, 0).to(_wide(x.dtype), memory_format=torch.contiguous_format,
                                copy=True)  # a copy of its own: the call writes into it
    return _reduce_scatter_rows(rows, group, inplace=True).movedim(0, dim).to(x.dtype)


def seq_gather(x: torch.Tensor, dim: int, group, mesh=None) -> torch.Tensor:
    """The ranks' blocks of ``x`` along ``dim`` (the sequence) concatenated
    in group order; its backward is the reduce-scatter of the cotangents
    along ``dim``, added in float32 (its SPMD transpose). The column
    block's input under ``seq_parallel``. With a ``mesh``, on its carrier."""
    if dist.get_world_size(group) == 1:
        return x
    return _Collective.apply(x, lambda t: _gather_along(t, dim, group),
                             lambda g: _scatter_sum_along(g, dim, group), mesh)


def seq_scatter_sum(x: torch.Tensor, dim: int, group, mesh=None) -> torch.Tensor:
    """This rank's block along ``dim`` of the group's sum of ``x``, added in
    float32 and cast back; its backward is the all-gather of the
    cotangents along ``dim`` (its SPMD transpose). The row block's output
    under ``seq_parallel``. With a ``mesh``, on its carrier."""
    if dist.get_world_size(group) == 1:
        return x
    return _Collective.apply(x, lambda t: _scatter_sum_along(t, dim, group),
                             lambda g: _gather_along(g, dim, group), mesh)


def part_wants(parts: int, whole: int, n: int) -> tuple:
    """What each of ``n`` ranks wants of a last dim of ``whole`` columns
    made of ``parts`` equal parts side by side (Mamba's ``[x | z]``, the
    sLSTM's ``[i | f | z | o]``) for ``fetch_columns``: rank r its channel
    block r of every part, ``[part 0's block r | part 1's block r | …]``."""
    if whole % parts or (whole // parts) % n:
        raise ValueError(f"{parts} parts of {whole} columns do not split over the tensor axis "
                         f"({n})")
    W, w = whole // parts, whole // parts // n
    return tuple(tuple((p * W + r * w, p * W + (r + 1) * w) for p in range(parts))
                 for r in range(n))


@functools.lru_cache(maxsize=None)
def fetch_plan(wants: tuple, whole: int, r: int):
    """The exchange ``fetch_columns`` runs on rank ``r``: a last dim of
    ``whole`` columns cut into ``len(wants)`` equal blocks, block j on rank
    j, rank j wanting the ascending, disjoint [start, stop) ranges
    ``wants[j]``. Returns (order, send, recv): the rank's columns in the
    order they leave (by the rank they go to, each run ascending; a column
    several ranks want leaves once for each), how many go to each rank,
    how many come from each."""
    n = len(wants)
    blk = whole // n
    lo, hi = r * blk, (r + 1) * blk

    def cut(ranges, a, b):
        return [c for start, stop in ranges for c in range(max(start, a), min(stop, b))]

    runs = [cut(want, lo, hi) for want in wants]
    order = tuple(c - lo for run in runs for c in run)
    recv = tuple(len(cut(wants[r], j * blk, (j + 1) * blk)) for j in range(n))
    return order, tuple(map(len, runs)), recv


@functools.lru_cache(maxsize=None)
def _plan_index(wants: tuple, whole: int, r: int, device) -> torch.Tensor:
    """``fetch_plan``'s order as an index tensor on ``device``, made once."""
    return torch.tensor(fetch_plan(wants, whole, r)[0], dtype=torch.long, device=device)


def _exchange_cols(x: torch.Tensor, send, recv, group) -> torch.Tensor:
    """An all-to-all along the last dim: ``send[j]`` columns to rank j (in
    order), ``recv[j]`` from rank j, concatenated in rank order."""
    rows = x.movedim(-1, 0).contiguous()
    out = rows.new_empty((sum(recv), *rows.shape[1:]))
    dist.all_to_all_single(out, rows, list(recv), list(send), group=group)
    return out.movedim(0, -1)


def fetch_columns(x: torch.Tensor, wants: tuple, group, mesh=None) -> torch.Tensor:
    """The columns this rank wants (``wants[rank]``, in ascending order) of a
    last dim cut contiguously over the group, from its stored block ``x``
    (..., whole / n): one all-to-all (``fetch_plan``). Its backward, the
    SPMD transpose, is the reverse all-to-all of the cotangents, each
    added into the column it came from (a column that several ranks
    fetched gets the sum of their cotangents). With a ``mesh``, on its
    carrier."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return x
    whole = x.shape[-1] * n
    _, send, recv = fetch_plan(wants, whole, r)

    def forward(t):
        return _exchange_cols(t.index_select(-1, _plan_index(wants, whole, r, t.device)),
                              send, recv, group)

    def backward(g):
        back = _exchange_cols(g, recv, send, group)
        idx = _plan_index(wants, whole, r, back.device)
        return back.new_zeros((*back.shape[:-1], whole // n)).index_add_(-1, idx, back)

    return _Collective.apply(x, forward, backward, mesh)


def all_max(x: torch.Tensor, group, mesh=None) -> torch.Tensor:
    """The elementwise maximum over the group, outside autograd (a shift
    that cancels, as a log-sum-exp's max). With a ``mesh``, on its carrier."""
    if dist.get_world_size(group) == 1:
        return x.detach()

    def top(t):
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
        return out

    return _on_carrier(top, x.detach(), mesh)


class TensorParallel:
    """The tensor axis of the active mesh as the dense layers and the
    mixers compute on it (``tensor_parallel``): its size, this rank's
    coordinate, its group
    (made when first asked for), the mesh whose carrier the collectives
    travel on, and whether the residual stream is cut along the sequence
    between blocks (``ShardRules.seq_parallel``). ``col_in`` and
    ``row_out`` are the pair around a column-then-row block: the identity
    and ``tp_sum``, or under ``seq_parallel`` ``seq_gather`` and
    ``seq_scatter_sum`` along the sequence (dim 1 of (B, S, d)).

    A column block's input is the identity both ways. Its copies'
    cotangents stay partial, one part a rank: under the sharded step's
    convention every path from a replicated value ends in a sum over the
    tensor axis (a row block's ``tp_sum`` backward, ``seq_gather``'s
    reduce-scatter, the all-gather's transpose, the gradient sum of a leaf
    computed whole), and the backward is linear in the cotangents, so the
    parts are added there once each."""

    def __init__(self, rules, mesh):
        self.rules, self.mesh = rules, mesh
        self.axis = rules.tensor_axis
        self.size = mesh.sizes[self.axis]
        self.coord = mesh.coords[self.axis]
        self.seq_parallel = bool(rules.seq_parallel)

    @classmethod
    def one_process(cls) -> "TensorParallel":
        """The axis of one process, size 1: every collective the identity,
        every leaf whole. The recurrent mixers run their one body on it
        where no axis is given."""
        tp = cls.__new__(cls)
        tp.rules = tp.mesh = tp.axis = None
        tp.size, tp.coord, tp.seq_parallel = 1, 0, False
        return tp

    @property
    def group(self):
        return self.mesh.group(self.axis)

    def for_decode(self) -> "TensorParallel":
        """The axis as the decode computes on it: ``col_in`` the identity and
        ``row_out`` the sum, whatever ``seq_parallel`` says (one token a row
        has no sequence to cut, and the reference's decode never reads the
        field)."""
        if not self.seq_parallel:
            return self
        tp = copy.copy(self)
        tp.seq_parallel = False
        return tp

    def sum(self, x):
        return x if self.size == 1 else tp_sum(x, self.group, self.mesh)

    def gather_seq(self, x):
        return x if self.size == 1 else seq_gather(x, 1, self.group, self.mesh)

    def scatter_seq(self, x):
        return x if self.size == 1 else seq_scatter_sum(x, 1, self.group, self.mesh)

    def own_seq(self, x):
        """This rank's block of a replicated (B, S, ...) along the sequence."""
        S = x.shape[1]
        if S % self.size:
            raise ValueError(f"a sequence of {S} does not split over the tensor axis "
                             f"({self.size}) under seq_parallel")
        step = S // self.size
        return x[:, self.coord * step:(self.coord + 1) * step]

    def col_in(self, x):
        return self.gather_seq(x) if self.seq_parallel else x

    def row_out(self, x):
        return self.scatter_seq(x) if self.seq_parallel else self.sum(x)

    def gather_cols(self, w):
        """A leaf cut by columns on the tensor axis, whole (differentiable:
        the backward is the rank's block of the summed cotangents)."""
        if self.size == 1:
            return w
        return all_gather(w.t(), self.group, mesh=self.mesh).t()

    def own_parts(self, x, parts: int):
        """The rank's channels of every one of ``parts`` equal parts from its
        stored block of a last dim cut contiguously over the axis
        (``part_wants``): a ``[x | z]`` leaf's rank r < m/2 holds only x
        columns, its rank r ≥ m/2 only z columns."""
        if self.size == 1:
            return x
        return self.fetch(x, part_wants(parts, x.shape[-1] * self.size, self.size))

    def fetch(self, x, wants: tuple):
        """The columns this rank wants, ``wants[coord]``, from its stored
        block of a last dim cut contiguously over the axis
        (``fetch_columns``)."""
        return x if self.size == 1 else fetch_columns(x, wants, self.group, self.mesh)

    def max(self, x):
        return all_max(x, self.group, self.mesh) if self.size > 1 else x.detach()

    def gather_last(self, x):
        """The ranks' blocks of ``x`` along its last dim, concatenated in
        group order (the backward sums each block's cotangents over the
        axis, as ``all_gather``'s)."""
        if self.size == 1:
            return x
        return all_gather(x.movedim(-1, 0).contiguous(), self.group,
                          mesh=self.mesh).movedim(0, -1)


def lse_combine(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,  # noqa: E741
                tp: TensorParallel) -> torch.Tensor:
    """The softmax attention of each query over the keys of every rank's
    block, from the ranks' partials over their own blocks (split-KV): ``o``
    (..., e) the unnormalised float32 Σ exp(s − m)·v, ``m`` (...) the row
    max of the scores, ``l`` (...) Σ exp(s − m). With M the max of ``m``
    over the axis each partial weighs exp(m − M), and one float32 sum over
    the axis carries the weighted ``o`` and ``l`` together: Σ o·w / Σ l·w.
    A rank that sees no key fills its scores with a finite -1e30, so its
    ``m`` is that fill and its weight exactly 0 (the rank that owns the
    query's position sees at least that key). Outside autograd."""
    if tp.size == 1:
        return o / l[..., None]
    w = torch.exp(m - tp.max(m))
    both = tp.sum(torch.cat([o * w[..., None], (l * w)[..., None]], dim=-1))
    return both[..., :-1] / both[..., -1:]


def tensor_parallel() -> TensorParallel | None:
    """The active mesh's tensor axis (``dist.sharding.set_active``), or
    None with no rules active (one process: the leaves whole)."""
    from repro_torch.dist import sharding as SH

    act = SH.active()
    if act is None:
        return None
    rules, mesh = act
    if rules.tensor_axis not in mesh.sizes:
        raise ValueError(f"the active mesh {mesh.axis_names} has no tensor axis "
                         f"{rules.tensor_axis!r}")
    return TensorParallel(rules, mesh)


def dragonfly_all_to_all_compute(x, group, layout: DeviceLayout,
                                 compute, backend=None,
                                 embedding: Embedding | None = None,
                                 offset: int = 1):
    """Fused §3 dispatch + per-destination compute + combine round trip:
    out[j] = compute_j(x[j]) — every chunk processed AT rank j and
    returned to its sender, replacing a dispatch all-to-all, a batched
    local transform, and a combine all-to-all with ONE overlapped pipeline
    (Schedules 1–3: wave w's exchanges fly while wave w-1's arrivals are
    contracted). ``compute`` is THIS shard's batched chunk transform
    (called with the (V, ...) stack of one wave's arrivals — close it over
    the shard's weights); ``offset`` picks the launch schedule. Bit-exact
    vs the sequential three-step form for chunk-batchable ``compute``.

    With an ``embedding``, ``layout`` is the guest and the round trip runs
    on the host group; idle ranks contribute nothing and their rows stay
    zero. ``dragonfly_round_trip`` is the same round trip under autograd."""
    be = _resolve_backend(backend)
    return be.alltoall_compute(
        x, group,
        alltoall_program(layout, embedding, pipelined=offset), compute)


class _RoundTrip(torch.autograd.Function):
    """The fused round trip under autograd. The forward runs the wave
    pipeline (``run(x, compute)``) with ``fn(weights, arrivals)`` as each
    wave's compute, no grad inside, and, where a gradient is wanted, saves
    each wave's arrivals in call order (``save_for_backward``, so that a
    non-reentrant checkpoint frees them and its recompute makes them
    again; a forward without grad keeps none). The backward runs the same
    pipeline on the cotangent: the compute of wave k becomes the VJP of
    ``fn`` in its arrivals at wave k's saved arrivals (``fn`` run again
    with grad), so each chunk's input cotangent goes back to its sender;
    the weights' gradient, the sum over the waves on this rank, which owns
    them, is one VJP of ``fn`` over every wave's arrivals and cotangents
    stacked (``fn`` takes any stack of chunks), so it is rounded to the
    weights' dtype once, as the unfused exchange's expert product rounds
    it."""

    @staticmethod
    def forward(ctx, x, run, fn, *weights):
        keep = any(ctx.needs_input_grad)
        arrivals = []

        def compute(h):
            if keep:
                arrivals.append(h)
            return fn(weights, h)

        out = run(x, compute)
        ctx.run, ctx.fn, ctx.n_weights = run, fn, len(weights)
        ctx.save_for_backward(*weights, *arrivals)
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        weights, arrivals = saved[:ctx.n_weights], saved[ctx.n_weights:]
        kept = iter(arrivals)
        cotangents = []

        def vjp(gh):
            h = next(kept).detach().requires_grad_(True)
            cotangents.append(gh)
            with torch.enable_grad():
                (gx,) = torch.autograd.grad(ctx.fn(weights, h), h, gh)
            return gx

        gx = ctx.run(g.contiguous(), vjp)
        if next(kept, None) is not None:
            raise AssertionError("the backward's pipeline ran fewer waves than the forward's")
        wgrads = [None] * len(weights)
        need = [i for i, w in enumerate(weights) if ctx.needs_input_grad[3 + i]]
        if need:
            ws = [w.detach().requires_grad_(i in need) for i, w in enumerate(weights)]
            with torch.enable_grad():
                y = ctx.fn(ws, torch.cat(arrivals))
            for i, gw in zip(need, torch.autograd.grad(y, [ws[i] for i in need],
                                                      torch.cat(cotangents))):
                wgrads[i] = gw
        return (gx, None, None, *wgrads)


def dragonfly_round_trip(x, weights, fn, group, layout: DeviceLayout, backend, mesh=None):
    """``dragonfly_all_to_all_compute`` with ``compute = fn(weights, ·)``
    on ``backend`` (a fused one), differentiable in ``x`` and in
    ``weights`` (``_RoundTrip``): out[j] = fn(weights of rank j, x[j]).
    Without grad it gives the bits of ``dragonfly_all_to_all_compute``.
    With a ``mesh`` the payload travels on its carrier both ways; ``fn``
    takes and returns carrier tensors."""

    def run(t, compute):
        return _on_carrier(lambda c: dragonfly_all_to_all_compute(
            c, group, layout, compute, backend=backend), t, mesh)

    return _RoundTrip.apply(x, run, fn, *weights)


def dragonfly_all_reduce(x, group, layout: DeviceLayout, backend=None,
                         embedding: Embedding | None = None):
    """§4 ascend all-reduce (sum) over the emulated hypercube; with an
    ``embedding``, guest-sized on the host group (idle ranks unchanged)."""
    be = _resolve_backend(backend)
    return be.allreduce(x, group, allreduce_program(layout, embedding))


def dragonfly_broadcast(x, group, layout: DeviceLayout, root: int = 0,
                        backend=None, embedding: Embedding | None = None):
    """§5 depth-3 spanning-tree broadcast from GUEST device ``root`` (the
    rewrite maps it to its host rank when an ``embedding`` is given)."""
    be = _resolve_backend(backend)
    return be.broadcast(x, group, broadcast_program(layout, root, embedding))


def dragonfly_matmul(b_block, a_block, group, grid: tuple[int, int],
                     backend=None, embedding: Embedding | None = None):
    """§2 block matrix product on the K×K array of M×M blocks, executed by
    the program executor — the paper's rounds on the wire, no gather.

    Runs on every rank of a group of K²M² ranks in router order. Rank r
    holds the (X, X) blocks ``b_block``/``a_block`` of B and A
    under the §2 storage map (``core.matmul.block_of_router``) and returns
    its block of B @ A in the same map. Each round broadcasts one row
    strip of B (phases 2.1/2.2), forms the local block products, and
    converges them over the mirrored accumulation paths (ReduceCombine
    matchings + the Z-fix storage hop) — Theorem 1's √n-round structure,
    one exchange per stage. With an ``embedding`` the guest D3(K²,M)
    product runs on the host group: active ranks hold the guest blocks at
    their ``active_devices`` slots, idle blocks are ignored and their
    output stays zero."""
    be = _resolve_backend(backend)
    return be.matmul(b_block, a_block, group, matmul_program(*grid, embedding))
