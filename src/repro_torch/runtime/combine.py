"""Concurrent guests — multiplex disjoint D3(J,L) workloads on one host mesh.

Paper Property 2 gives D3(K,M) a dilation-1 copy of every smaller D3(J,L);
``runtime.rewrite.emulate`` makes ONE such guest executable per host. This
module makes N of them executable AT ONCE: ``combine(programs)`` merges N
already-rewritten guest programs whose ``active_devices`` images are
pairwise disjoint into a single host-sized ``CollectiveProgram`` that any
conforming backend replays unchanged.

Why this is sound: a Property-2 image C × P × P is *closed* — every link a
guest hop traverses connects two routers of the image — so disjoint router
images use disjoint sets of directed physical links. Interleaving the
guests' stages therefore cannot create a link conflict, and because a
stage only ever reads/writes devices of its own guest, ANY replay order
that preserves each guest's own stage order is bit-exact per guest. The
combined makespan is max(T_1..T_N) synchronous rounds instead of the
ΣT_i a time-multiplexed host would pay.

The merge packs aggressively: stages from different guests that share one
``(round_index, step, start_step)`` stamp and one type fuse into a single
partial stage (disjoint ``Perm``s become one partial permutation, ``Match``
/ ``ReduceCombine`` pair sets union), so the combined program has the SAME
stage count per step group as the widest guest — one exchange moves
both guests' chunks. Stages whose stamps differ simply coexist; barrier
replay still groups them by ``(round_index, step)``.

Conflicts are re-checked, not assumed: ``combine`` walks every synchronous
step group across guests with the paper's conflict model (a directed link
serves one packet per step; only ``ReduceCombine`` destinations may repeat
within a group) and raises a structured ``GuestConflictError`` carrying
the offending ``(step, link)`` and guest indices — overlapping images are
reported the same way before any merge happens. ``combine_schedules`` is
the Schedule-IR companion: it merges the guests' host-graph Schedule views
(``rewrite.emulate_schedule`` output) into one Schedule that
``core.simulator.verify`` — the same conflict checker every algorithm's
tests use — replays on the literal host links.

Matmul programs carry non-communication ``LocalContract`` stages that
backends apply to EVERY device (idle devices just hold zero blocks), so
matmul guests must share one local-contract skeleton — same grid shape,
same round structure; ``combine`` verifies this and merges the skeletons
positionally (``store_c`` masks union). Combined matmul programs replay at
the blocks level (``matmul_blocks`` / the per-shard ``matmul`` method):
each guest's blocks are scattered to its own slots with its solo program,
and results extracted per guest (below).

Per-guest data movement: ``scatter_guests`` packs N guest-sized arrays
into one host-sized array (each guest at its own ``active_devices``
slots); ``gather_guests`` / ``extract_guest`` pull each guest's result
back out through ``Embedding.host_to_guest`` (or a rewritten program's
``active_devices``). Pure Python + NumPy over hashable data — ``combine``
is memoized, so elastic failover can re-combine a surviving tenant set as
cheaply as it re-emulates a single guest.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core.emulation import Embedding
from repro_torch.core.schedule import Round, Schedule
from repro_torch.runtime.program import (
    CollectiveProgram,
    LocalContract,
    Match,
    Perm,
    ReduceCombine,
    Stage,
)
from repro_torch.runtime.rewrite import gather_guest


class GuestConflictError(ValueError):
    """Two guests collide — overlapping device images or a step conflict.

    ``guests`` holds the offending guest indices (positions in the
    ``combine`` argument). For image overlaps ``device`` is the shared host
    device id. For step conflicts ``step`` is the ``(round_index, step)``
    stamp, plus ``link`` — the contested directed ``(src, dst)`` pair —
    for link conflicts, or ``device`` — the doubly-written id — for write
    conflicts (``link`` is then the writing pair only if one traverses a
    link).
    """

    def __init__(self, message: str, *, guests=None, device=None,
                 step=None, link=None):
        super().__init__(message)
        self.guests = guests
        self.device = device
        self.step = step
        self.link = link


# ---------------------------------------------------------------------------
# Validation: disjoint images + cross-guest step-conflict re-check.
# ---------------------------------------------------------------------------

def _check_images_disjoint(programs) -> None:
    seen: dict[int, int] = {}
    for gi, prog in enumerate(programs):
        for dev in prog.active_devices:
            gj = seen.setdefault(dev, gi)
            if gj != gi:
                raise GuestConflictError(
                    f"guests {gj} and {gi} overlap on host device {dev}",
                    guests=(gj, gi), device=dev,
                )


def _stage_events(st: Stage):
    """(src, dst, uses_link) triples for a communication stage: identity
    ``ReduceCombine`` pairs WRITE their own accumulator but use no link."""
    if isinstance(st, (Perm, Match)):
        return [(s, d, True) for s, d in st.pairs]
    if isinstance(st, ReduceCombine):
        return [(s, d, s != d) for s, d in st.pairs]
    return []


def check_step_conflicts(programs) -> None:
    """Re-check the paper's conflict model across guests, step by step.

    Within one synchronous ``(round_index, step)`` group, a directed device
    link may serve ONE packet, and no device may be written by two GUESTS
    — repeated writes are legal only intra-guest (``ReduceCombine`` folds,
    per the backend contract), never across guests, since disjoint closed
    images put every destination inside exactly one guest. The check
    catches callers who merge programs that were not independently
    rewritten (and is cheap: one dict pass over the pair sets).
    """
    links: dict[tuple, int] = {}   # (round, step, src, dst) -> guest
    writes: dict[tuple, int] = {}  # (round, step, dst) -> guest
    for gi, prog in enumerate(programs):
        for st in prog.stages:
            key = (st.round_index, st.step)
            for s, d, uses_link in _stage_events(st):
                if uses_link:
                    prev = links.setdefault(key + (s, d), gi)
                    if prev != gi:
                        raise GuestConflictError(
                            f"guests {prev} and {gi} both use link {s}->{d} "
                            f"at step {key}",
                            guests=(prev, gi), step=key, link=(s, d),
                        )
                owner = writes.setdefault(key + (d,), gi)
                if owner != gi:
                    raise GuestConflictError(
                        f"guests {owner} and {gi} both write device {d} "
                        f"at step {key}",
                        guests=(owner, gi), step=key, device=d,
                        link=(s, d) if uses_link else None,
                    )


# ---------------------------------------------------------------------------
# Stage merging.
# ---------------------------------------------------------------------------

def _stamps(st: Stage) -> dict:
    return dict(round_index=st.round_index, step=st.step,
                start_step=st.start_step)


def _merge_comm(stages: list[Stage], n: int) -> Stage:
    """Union same-type stages with identical stamps into one partial stage
    over the host's n devices (the packing step: disjoint guests' perms
    become ONE partial permutation — one exchange on the wire)."""
    st = stages[0]
    pairs = tuple(p for s in stages for p in s.pairs)
    if isinstance(st, Perm):
        return Perm(pairs, n=n, **_stamps(st))
    if isinstance(st, Match):
        return Match(n, pairs, **_stamps(st))
    assert isinstance(st, ReduceCombine)
    return ReduceCombine(n, pairs, combine=st.combine, **_stamps(st))


def _merge_homogeneous(programs, n: int) -> tuple[Stage, ...]:
    """Merge comm-only programs (alltoall / allreduce / broadcast).

    Stages bucket by ``(round_index, step, start_step, type)``; within a
    bucket each guest contributes an ordered run (broadcast fan-out emits
    several matchings per step) and the runs merge positionally, so every
    guest keeps its own stage order — the property replay correctness
    rides on. Buckets come out sorted by stamp, which coincides with each
    guest's own (round-major, step-minor) barrier order.
    """
    buckets: dict[tuple, list[list[Stage]]] = {}
    for prog in programs:
        mine: dict[tuple, list[Stage]] = {}
        for st in prog.stages:
            key = (st.round_index, st.step, st.start_step, type(st).__name__)
            mine.setdefault(key, []).append(st)
        for key, run in mine.items():
            buckets.setdefault(key, []).append(run)
    out: list[Stage] = []
    for key in sorted(buckets):
        runs = buckets[key]
        for i in range(max(len(r) for r in runs)):
            out.append(_merge_comm([r[i] for r in runs if i < len(r)], n))
    return tuple(out)


def _skeleton(prog: CollectiveProgram) -> tuple:
    return tuple(
        (type(st).__name__, getattr(st, "fn", None),
         st.round_index, st.step, st.start_step)
        for st in prog.stages
    )


def _merge_matmul(programs, n: int) -> tuple[Stage, ...]:
    """Positional merge of matmul programs sharing one local-contract
    skeleton (``load_b``/``mul_a``/``promote`` act on every device, so the
    guests' round structures must agree stage for stage)."""
    skel = _skeleton(programs[0])
    for gi, prog in enumerate(programs[1:], start=1):
        if _skeleton(prog) != skel:
            raise GuestConflictError(
                f"matmul guests 0 and {gi} have different local-contract "
                "skeletons (grids/round structures differ); combine only "
                "multiplexes matmul guests of one shape",
                guests=(0, gi),
            )
    out: list[Stage] = []
    for column in zip(*(p.stages for p in programs)):
        st = column[0]
        if isinstance(st, LocalContract):
            if st.mask is None:
                out.append(LocalContract(st.fn, n=n, **_stamps(st)))
            else:
                mask = tuple(i for s in column for i in s.mask)
                out.append(LocalContract(st.fn, mask=mask, n=n, **_stamps(st)))
        else:
            out.append(_merge_comm(list(column), n))
    return tuple(out)


# ---------------------------------------------------------------------------
# The combinator.
# ---------------------------------------------------------------------------

def combine(programs, name: str = "") -> CollectiveProgram:
    """Merge N rewritten guest programs into one concurrent host program.

    Every input must be an emulation rewrite (``active_devices`` set) of
    the SAME kind on the SAME host size, with pairwise-disjoint device
    images — violations raise ``GuestConflictError``. The result's
    ``active_devices`` is the guests' images concatenated in argument
    order (guest g's devices at offset ``sum(guest_n of guests < g)``),
    its round count is ``max`` over guests, and its stages are the packed
    merge described in the module docstring. A single program passes
    through unchanged (after validation — it must still be a rewrite).
    Memoized per (programs, name) — programs are frozen/hashable, so
    failover re-combines are cache hits.
    """
    return _combine(tuple(programs), name)


@functools.lru_cache(maxsize=None)
def _combine(programs: tuple[CollectiveProgram, ...],
             name: str) -> CollectiveProgram:
    if not programs:
        raise ValueError("combine() needs at least one program")
    first = programs[0]
    for gi, prog in enumerate(programs):
        if prog.kind != first.kind:
            raise ValueError(
                f"cannot combine kinds {first.kind!r} and {prog.kind!r} "
                f"(guest {gi}): backends replay one kind per program"
            )
        if prog.n != first.n:
            raise ValueError(
                f"guest {gi} is host-sized {prog.n}, expected {first.n}"
            )
        if prog.active_devices is None:
            raise ValueError(
                f"guest {gi} is a native (full-mesh) program; combine takes "
                "emulation rewrites — pass it through rewrite.emulate first"
            )
    if len(programs) == 1:  # validated pass-through: already a rewrite
        return first
    _check_images_disjoint(programs)
    check_step_conflicts(programs)
    if first.kind == "matmul":
        stages = _merge_matmul(programs, first.n)
    else:
        stages = _merge_homogeneous(programs, first.n)
    grids = {p.grid for p in programs}
    return CollectiveProgram(
        kind=first.kind,
        n=first.n,
        num_rounds=max(p.num_rounds for p in programs),
        stages=stages,
        root=None,  # per-guest roots live on the solo programs
        grid=grids.pop() if len(grids) == 1 else None,
        name=name or "+".join(p.name or p.kind for p in programs),
        active_devices=tuple(d for p in programs for d in p.active_devices),
    )


def combine_schedules(schedules, name: str = "") -> Schedule:
    """Merge host-graph Schedule views (``rewrite.emulate_schedule`` output)
    for the Schedule-IR conflict checker.

    Round i of every guest lands in round-index-i position of the merged
    schedule (the barrier window ``combine`` merges programs by), SPLIT
    per distinct ``start_step`` stamp so pipelined replay launches every
    guest's rounds at its own offsets — mixed-shape pipelined guests whose
    stamps disagree keep them instead of defaulting to 0. Payloads are
    namespaced ``(guest_index, payload)`` so the verifier attributes
    conflicts to guests. ``core.simulator.verify`` on the result — zero
    conflicts, barrier and pipelined — is the IR-level proof that the
    combined program's step groups fit the host links concurrently.
    """
    schedules = list(schedules)
    if not schedules:
        raise ValueError("combine_schedules() needs at least one schedule")
    topo = schedules[0].topo
    for sched in schedules[1:]:
        if sched.topo != topo:
            raise ValueError(
                f"host topologies differ: D3({topo.K},{topo.M}) vs "
                f"D3({sched.topo.K},{sched.topo.M})"
            )
    num_rounds = max(s.num_rounds for s in schedules)
    rounds: list[Round] = []
    for i in range(num_rounds):
        by_start: dict = {}  # start_step stamp (or None) -> merged hops
        for gi, sched in enumerate(schedules):
            if i >= sched.num_rounds:
                continue
            rnd = sched.rounds[i]
            by_start.setdefault(rnd.meta.get("start_step"), []).extend(
                dataclasses.replace(h, payload=(gi, h.payload))
                for h in rnd.hops
            )
        for start in sorted(by_start, key=lambda s: (s is not None, s or 0)):
            meta = {} if start is None else {"start_step": start}
            rounds.append(Round(tuple(by_start[start]), meta))
    return Schedule(
        name or "+".join(s.name for s in schedules), topo, rounds,
        {"guests": len(schedules)},
    )


# ---------------------------------------------------------------------------
# Per-guest data movement around a combined replay.
# ---------------------------------------------------------------------------

def _guest_index(guest) -> np.ndarray:
    """Guest-ordered host device ids of an ``Embedding`` (its cached
    ``device_map``, i.e. the ``host_to_guest`` inverse) or of a rewritten
    program (``active_devices``)."""
    if isinstance(guest, Embedding):
        return guest.device_map
    prog = guest.program if hasattr(guest, "program") else guest
    if prog.active_devices is None:
        raise ValueError("native program has no guest view to extract")
    return prog.active_np


def extract_guest(x: np.ndarray, guest, *, axes=(0,)) -> np.ndarray:
    """Pull ONE guest's slice out of a host-sized combined replay result.

    ``guest`` is the guest's ``Embedding`` (mapped through its
    ``host_to_guest`` inverse) or its solo rewritten program (delegated to
    ``rewrite.gather_guest``). Each listed host axis shrinks to the
    guest's device count, in guest id order.
    """
    if not isinstance(guest, Embedding):
        prog = guest.program if hasattr(guest, "program") else guest
        if prog.active_devices is None:
            raise ValueError("native program has no guest view to extract")
        return gather_guest(np.asarray(x), prog, axes=axes)
    host_n = guest.host.num_routers
    idx = _guest_index(guest)
    out = np.asarray(x)
    for ax in axes:
        if out.shape[ax] != host_n:
            raise ValueError(
                f"axis {ax} has {out.shape[ax]} slots, host has {host_n}"
            )
        sel = [slice(None)] * out.ndim
        sel[ax] = idx
        out = out[tuple(sel)]
    return out


def gather_guests(x: np.ndarray, guests, *, axes=(0,)) -> list[np.ndarray]:
    """``extract_guest`` for every guest of a combined replay, in order."""
    return [extract_guest(x, g, axes=axes) for g in guests]


def scatter_guests(xs, guests, host_shape=None, *, axes=(0,), fill=0) -> np.ndarray:
    """Pack per-guest arrays into ONE host-sized array for a combined
    replay: guest g's slice lands at its own device slots, every other slot
    holds ``fill``. ``host_shape`` defaults to the first array's shape with
    each listed axis widened to the host device count (taken from the first
    guest's embedding host / program n)."""
    xs = [np.asarray(x) for x in xs]
    guests = list(guests)
    if len(xs) != len(guests):
        raise ValueError(f"{len(xs)} arrays for {len(guests)} guests")
    g0 = guests[0]
    host_n = (g0.host.num_routers if isinstance(g0, Embedding)
              else (g0.program if hasattr(g0, "program") else g0).n)
    if host_shape is None:
        host_shape = list(xs[0].shape)
        for ax in axes:
            host_shape[ax] = host_n
    out = np.full(tuple(host_shape), fill,
                  np.result_type(fill, *(x.dtype for x in xs)))
    for x, guest in zip(xs, guests):
        idx = _guest_index(guest)
        for ax in axes:
            if x.shape[ax] != len(idx):
                raise ValueError(
                    f"axis {ax} has {x.shape[ax]} slots, guest has {len(idx)}"
                )
        # np.ix_-style cross-product index over the listed axes, slices
        # elsewhere: one advanced-index assignment per guest
        index: list = [slice(None)] * out.ndim
        for k, ax in enumerate(axes):
            shape = [1] * len(axes)
            shape[k] = len(idx)
            index[ax] = idx.reshape(shape)
        out[tuple(index)] = x
    return out


def run_matmul_guests(backend, Bs, As, program: CollectiveProgram, guests
                      ) -> list[np.ndarray]:
    """N whole-matrix §2 products through ONE combined replay.

    The whole-matrix twin of a combined ``matmul_blocks`` call: each
    guest's (N·X, N·X) factor matrices are cut into §2 blocks
    (``core.matmul.scatter_blocks``, grid = the shared guest grid), every
    guest's blocks land at its own host slots (``scatter_guests``), the
    backend replays the combined program ONCE at the blocks level, and each
    product matrix is reassembled from its guest's slots. Returns
    ``[B_g @ A_g for g in guests]`` in guest order.

    ``program`` must come from ``combine`` (or
    ``dist.collectives.concurrent_program('matmul', ...)``) over guests of
    ONE grid shape — that is the only combinable matmul case, and it is
    what makes ``program.grid`` the per-guest grid. ``backend`` needs the
    blocks-level entry point (``matmul_blocks``); the per-shard
    ``run_matmul`` wrappers can't express N disjoint whole matrices.
    """
    from repro_torch.core.matmul import MatmulGrid, gather_blocks, scatter_blocks

    if len(Bs) != len(As) or len(Bs) != len(guests):
        raise ValueError(
            f"{len(Bs)} B / {len(As)} A matrices for {len(guests)} guests"
        )
    if program.kind != "matmul":
        raise ValueError(f"expected a matmul program, got {program.kind!r}")
    if program.grid is None:
        raise ValueError(
            "combined program lacks grid metadata — matmul guests of mixed "
            "grid shapes cannot share one whole-matrix replay"
        )
    if not hasattr(backend, "matmul_blocks"):
        raise ValueError(
            f"backend {getattr(backend, 'name', type(backend).__name__)!r} "
            "has no blocks-level matmul entry point (matmul_blocks); the "
            "combined whole-matrix wrapper needs it"
        )
    g = MatmulGrid(*program.grid)
    bs = [scatter_blocks(g, np.asarray(B)) for B in Bs]
    as_ = [scatter_blocks(g, np.asarray(A)) for A in As]
    host_shape = (program.n, *bs[0].shape[1:])
    bh = scatter_guests(bs, guests, host_shape)
    ah = scatter_guests(as_, guests, host_shape)
    ch = backend.matmul_blocks(bh, ah, program)
    return [gather_blocks(g, cg) for cg in gather_guests(ch, guests)]
