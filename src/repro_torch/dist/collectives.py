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
"""

from __future__ import annotations

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


# ------------------------------------------------------------- collectives
def native_all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """Reference: ``torch.distributed``'s own all-to-all, same (n, ...)
    chunk layout (x[j] goes to rank j; out[j] came from rank j)."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def dragonfly_all_to_all(x, group, layout: DeviceLayout, backend=None,
                         embedding: Embedding | None = None):
    """§3 doubly-parallel all-to-all: K·M²/s rounds of s exchanges.

    ``x``: (n, ...) with x[j] = chunk for rank j; returns (n, ...) with
    out[j] = chunk from rank j (``native_all_to_all``'s layout). With an
    ``embedding``, ``layout`` is the guest and the exchange runs on the
    host group (n = host routers); idle ranks pass zeros through."""
    be = _resolve_backend(backend)
    pipelined = 1 if getattr(be, "overlap_fused", False) else 0
    return be.alltoall(
        x, group, alltoall_program(layout, embedding, pipelined=pipelined))


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
    zero."""
    be = _resolve_backend(backend)
    return be.alltoall_compute(
        x, group,
        alltoall_program(layout, embedding, pipelined=offset), compute)


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
