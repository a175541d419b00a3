"""Emulation rewrite — lower any D3(J,L) program onto its D3(K,M) host.

Paper Property 2 (embeddings formalized in Draper, *The Swapped Dragonfly*,
arXiv:2202.01843): D3(K,M) contains a dilation-1 copy of every D3(J,L)
with J ≤ K, L ≤ M. ``emulate(program, embedding)`` is that property as a
program-to-program pass: every ``Perm``/``Match``/``ReduceCombine`` pair
set of an already-lowered guest ``CollectiveProgram`` is relabeled through
the embedding's vectorized device-id map (guest router id → host router id,
``Embedding.device_map``), ``LocalContract`` store masks are relabeled the
same way, and the result is a host-sized program whose ``active_devices``
tuple records (in guest order) which host devices participate. Because the
embedding is dilation-1, every rewritten pair is still a single physical
link of the host graph, so the guest schedule's conflict-freedom transfers
verbatim — no re-derivation, no re-verification, no re-lowering.

What the pass guarantees (the contract tests and ``train.fault_tolerance``
rely on):

  * **stamps survive** — ``(round_index, step, start_step)`` are copied
    unchanged, so pipelined (start_step-ordered) replay of the rewritten
    program interleaves exactly like the guest's;
  * **bit-exactness** — replaying the rewritten program on host arrays that
    carry the guest data at ``active_devices`` slots produces, at those
    slots, bit-for-bit the guest program's result on any conforming
    backend (differential-tested: reference, cuda_fused and torch_dist);
  * **idle isolation** — host devices outside ``active_devices`` neither
    contribute to nor receive guest data: their slots pass through
    untouched (asserted by the reference backend);
  * **caching** — ``emulate`` is memoized on the hashable
    ``(program, embedding)`` key, i.e. on (host, guest, c_set, p_set,
    program), the same way per-stage σ/σ⁻¹ arrays are cached — repeated
    failover re-lowers reuse the built host index arrays instead of
    rebuilding them.

``emulate_schedule`` is the companion *verification* view: it maps a guest
Schedule IR's hops router-by-router onto the host graph so
``core.simulator.verify`` can replay them on the literal host links
(dilation-1 ⇒ zero conflicts). Its output is for verify()/price() only —
lowering metadata (``vectors``/``pairs``/``matmul``) is moved under
``guest_*`` keys so the result cannot be accidentally re-lowered; use
``emulate`` for the executable program.

Pure Python + NumPy over hashable data — no torch, safe to call from the
reference backend and from host-side recovery planning.
"""

from __future__ import annotations

import functools

import numpy as np

from repro_torch.core.emulation import Embedding
from repro_torch.core.schedule import Hop, Round, Schedule
from repro_torch.runtime.program import (
    CollectiveProgram,
    LocalContract,
    Match,
    Perm,
    ReduceCombine,
    Stage,
)

#: round meta keys that drive ``runtime.lowering`` dispatch — moved under
#: ``guest_*`` by ``emulate_schedule`` so its output is verify-only.
_LOWERING_META = ("vectors", "pairs", "matmul")


def _check_embedding(program: CollectiveProgram, embedding: Embedding) -> None:
    if embedding.guest.num_routers != program.n:
        raise ValueError(
            f"program acts on {program.n} devices but the embedding's guest "
            f"D3({embedding.guest.K},{embedding.guest.M}) has "
            f"{embedding.guest.num_routers}"
        )
    if program.active_devices is not None:
        raise ValueError(
            "program is already an emulation rewrite; compose embeddings "
            "instead of stacking rewrites"
        )


@functools.lru_cache(maxsize=None)
def emulate(program: CollectiveProgram, embedding: Embedding) -> CollectiveProgram:
    """Rewrite a guest ``CollectiveProgram`` onto the embedding's host.

    Returns a program with ``n = host.num_routers`` whose communication
    stages carry host device ids, whose (round_index, step, start_step)
    stamps are the guest's, and whose ``active_devices`` is the guest-
    ordered host image (``Embedding.device_map``). Memoized per
    (program, embedding) — both are frozen/hashable.
    """
    _check_embedding(program, embedding)
    dm = embedding.device_map
    host_n = embedding.host.num_routers

    def mapped(pairs):
        return tuple((int(dm[s]), int(dm[d])) for s, d in pairs)

    stages: list[Stage] = []
    for st in program.stages:
        stamps = dict(round_index=st.round_index, step=st.step,
                      start_step=st.start_step)
        if isinstance(st, Perm):
            stages.append(Perm(mapped(st.pairs), n=host_n, **stamps))
        elif isinstance(st, Match):
            stages.append(Match(host_n, mapped(st.pairs), **stamps))
        elif isinstance(st, ReduceCombine):
            stages.append(ReduceCombine(host_n, mapped(st.pairs),
                                        combine=st.combine, **stamps))
        elif isinstance(st, LocalContract):
            mask = None if st.mask is None else tuple(int(dm[i]) for i in st.mask)
            stages.append(LocalContract(st.fn, mask=mask, n=host_n, **stamps))
        else:  # pragma: no cover - Stage union is closed
            raise TypeError(f"unknown stage type {type(st).__name__}")
    return CollectiveProgram(
        kind=program.kind,
        n=host_n,
        num_rounds=program.num_rounds,
        stages=tuple(stages),
        root=None if program.root is None else int(dm[program.root]),
        grid=program.grid,
        name=f"{program.name or program.kind}@D3({embedding.host.K},{embedding.host.M})",
        active_devices=tuple(int(h) for h in dm),
    )


def emulate_schedule(schedule: Schedule, embedding: Embedding) -> Schedule:
    """Map a guest Schedule IR hop-by-hop onto the host graph — the
    verification companion of ``emulate``.

    Every hop's endpoints go through ``Embedding.map_router``; steps,
    payloads, ``start_step``/``startups`` metadata are preserved, so
    ``core.simulator.verify(host_topo, emulate_schedule(s, emb))`` replays
    the guest schedule on the literal host links (and must report zero
    conflicts — dilation 1). Lowering-dispatch metadata is stashed under
    ``guest_*`` keys: the result is for verify()/price(), not for
    ``runtime.lowering.lower``.
    """
    if schedule.topo != embedding.guest:
        raise ValueError(
            f"schedule is on D3({schedule.topo.K},{schedule.topo.M}) but the "
            f"embedding's guest is D3({embedding.guest.K},{embedding.guest.M})"
        )
    mr = embedding.map_router
    rounds = []
    for rnd in schedule.rounds:
        hops = tuple(Hop(h.step, mr(h.src), mr(h.dst), h.payload) for h in rnd.hops)
        meta = dict(rnd.meta)
        for key in _LOWERING_META:
            if key in meta:
                meta[f"guest_{key}"] = meta.pop(key)
        rounds.append(Round(hops, meta))
    meta = dict(schedule.meta)
    for key in ("root", "source"):
        if meta.get(key) is not None:
            root = meta[key]
            meta[key] = (
                int(embedding.device_map[root]) if isinstance(root, int)
                else mr(root)
            )
    return Schedule(
        f"{schedule.name}@D3({embedding.host.K},{embedding.host.M})",
        embedding.host, rounds, meta,
    )


# ---------------------------------------------------------------------------
# Guest-view scatter/gather: move guest-sized arrays in and out of the
# host-sized device axis of a rewritten program.
# ---------------------------------------------------------------------------

def scatter_guest(x: np.ndarray, program: CollectiveProgram, *, axes=(0,),
                  fill=0) -> np.ndarray:
    """Embed guest-sized array ``x`` into the rewritten program's host axis.

    Each listed axis of length ``guest_n`` becomes a host axis of length
    ``n`` with guest slice g landing at host index ``active_devices[g]``
    and idle slots holding ``fill``. Identity for native programs.
    """
    if program.active_devices is None:
        return np.asarray(x)
    out = np.asarray(x)
    idx = program.active_np
    for ax in axes:
        if out.shape[ax] != program.guest_n:
            raise ValueError(
                f"axis {ax} has {out.shape[ax]} slots, guest has {program.guest_n}"
            )
        shape = list(out.shape)
        shape[ax] = program.n
        host = np.full(shape, fill, out.dtype)
        sel = [slice(None)] * out.ndim
        sel[ax] = idx
        host[tuple(sel)] = out
        out = host
    return out


def gather_guest(x: np.ndarray, program: CollectiveProgram, *, axes=(0,)) -> np.ndarray:
    """Project the rewritten program's host axis back to the guest view —
    the inverse of ``scatter_guest`` (idle slots are dropped)."""
    if program.active_devices is None:
        return np.asarray(x)
    out = np.asarray(x)
    idx = program.active_np
    for ax in axes:
        if out.shape[ax] != program.n:
            raise ValueError(
                f"axis {ax} has {out.shape[ax]} slots, host has {program.n}"
            )
        sel = [slice(None)] * out.ndim
        sel[ax] = idx
        out = out[tuple(sel)]
    return out
