"""Property 2 — sub-network emulation: D3(J, L) ⊂ D3(K, M).

The routers of D3(K,M) with c in a J-subset C ⊆ Z_K and BOTH d and p in an
L-subset P ⊆ Z_M form a closed subnetwork isomorphic (dilation-1) to
D3(J, L), provided C and P are subgroups-like index sets closed under the
difference arithmetic the ports use. We use the canonical choice
C = {0..J-1} with port arithmetic relabeled through the subset index —
i.e. the embedded network's port g means "go to the g-th element of C",
realized on D3(K,M) by the port (C[(idx(c)+g) % J] - c) mod K, which is a
legal global port. Same for local ports within P.

This is the framework's *elastic scaling* mechanism: when chips die, the
runtime selects the largest (J, L) with J ≤ K, L ≤ M such that a healthy
C × P × P router set exists and REWRITES the already-lowered D3(J, L)
programs onto the survivors through ``Embedding.device_map`` (the
program-to-program pass in ``runtime.rewrite``) — recovery never re-derives
schedules. See train/fault_tolerance.py.

It is also the *multi-tenancy* mechanism: because a C × P × P image is
closed under every port the guest uses, two embeddings with disjoint
images occupy disjoint routers AND disjoint links, so their rewritten
programs can interleave on one host with zero conflicts
(``runtime.combine``). ``disjoint_embeddings`` packs a list of guest
shapes into such pairwise-disjoint images.

Contract owed to the paper: Property 2 (§1/§6) — D3(K,M) emulates every
D3(J,L) with J ≤ K, L ≤ M at dilation 1, so round counts and
conflict-freedom of all four algorithms transfer verbatim from guest to
host; ``Embedding.verify`` asserts the dilation-1 property link by link.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

from repro_torch.core.topology import D3, Router


@dataclasses.dataclass(frozen=True)
class Embedding:
    """Maps D3(J, L) routers onto a C × P × P subset of D3(K, M)."""

    host: D3
    guest: D3
    c_set: tuple[int, ...]
    p_set: tuple[int, ...]

    def __post_init__(self) -> None:
        if len(self.c_set) != self.guest.K or len(self.p_set) != self.guest.M:
            raise ValueError("subset sizes must match guest dimensions")
        if len(set(self.c_set)) != len(self.c_set) or len(set(self.p_set)) != len(self.p_set):
            raise ValueError("subsets must be duplicate-free")
        if not all(0 <= c < self.host.K for c in self.c_set):
            raise ValueError(f"c_set {self.c_set} out of range for K={self.host.K}")
        if not all(0 <= p < self.host.M for p in self.p_set):
            raise ValueError(f"p_set {self.p_set} out of range for M={self.host.M}")

    def map_router(self, r: Router) -> Router:
        c, d, p = r
        return (self.c_set[c], self.p_set[d], self.p_set[p])

    # ------------------------------------------------- vectorized device maps
    @cached_property
    def device_map(self) -> np.ndarray:
        """``device_map[g]`` = host router id of guest router id ``g`` —
        the whole embedding as one int32 gather, built once and cached
        (hash/eq of the frozen dataclass ignore the cache, so embeddings
        stay valid dict/lru keys)."""
        c = np.asarray(self.c_set, np.int32)[:, None, None]
        d = np.asarray(self.p_set, np.int32)[None, :, None]
        p = np.asarray(self.p_set, np.int32)[None, None, :]
        ids = (c * self.host.M + d) * self.host.M + p
        ids = ids.reshape(-1)  # guest router-id order: c-major, then d, then p
        ids.setflags(write=False)
        return ids

    @cached_property
    def host_to_guest(self) -> np.ndarray:
        """Inverse map: host router id -> guest router id, or -1 for host
        devices outside the embedded subnetwork (the idle devices)."""
        inv = np.full(self.host.num_routers, -1, np.int32)
        inv[self.device_map] = np.arange(self.guest.num_routers, dtype=np.int32)
        inv.setflags(write=False)
        return inv

    def map_local_port(self, r: Router, delta: int) -> int:
        """Guest local port delta at guest router r -> host local port."""
        c, d, p = r
        src = self.p_set[p]
        dst = self.p_set[(p + delta) % self.guest.M]
        return (dst - src) % self.host.M

    def map_global_port(self, r: Router, gamma: int) -> int:
        c, d, p = r
        src = self.c_set[c]
        dst = self.c_set[(c + gamma) % self.guest.K]
        return (dst - src) % self.host.K

    def verify(self) -> None:
        """Every guest link maps to a host link (dilation 1) and the global
        hop's d/p swap is preserved."""
        g, h = self.guest, self.host
        for r in g.routers():
            hr = self.map_router(r)
            for delta in range(1, g.M):
                dst = g.local_hop(r, delta)
                hdst = self.map_router(dst)
                if not h.is_local_link(hr, hdst):
                    raise AssertionError(f"local {r}->{dst} maps to non-link {hr}->{hdst}")
            for gamma in range(g.K):
                dst = g.global_hop(r, gamma)
                if dst == r:
                    continue
                hdst = self.map_router(dst)
                if not h.is_global_link(hr, hdst):
                    raise AssertionError(f"global {r}->{dst} maps to non-link {hr}->{hdst}")


def embed(host: D3, J: int, L: int, c_set=None, p_set=None) -> Embedding:
    if J > host.K or L > host.M:
        raise ValueError("guest must not exceed host")
    c_set = tuple(c_set) if c_set is not None else tuple(range(J))
    p_set = tuple(p_set) if p_set is not None else tuple(range(L))
    emb = Embedding(host, D3(J, L), c_set, p_set)
    emb.verify()
    return emb


def disjoint_embeddings(host: D3, guest_shapes) -> tuple[Embedding, ...]:
    """Pack guest shapes [(J, L), ...] into pairwise-DISJOINT Property-2
    embeddings of ``host`` — the enumerator behind concurrent guests
    (``runtime.combine``).

    Disjointness needs only ONE axis to be partitioned, because an image
    is the product set C × P × P: guests on disjoint cabinet sets never
    share a router (whatever their position sets), and likewise for
    disjoint position sets. We try the cabinet regime first (Σ J ≤ K —
    each guest keeps all M positions available, mirroring
    ``largest_embeddable``'s tie-break toward whole drawers), then the
    position regime (Σ L ≤ M), and raise when neither fits. Every
    returned embedding is dilation-1-verified.
    """
    shapes = [(int(J), int(L)) for J, L in guest_shapes]
    if not shapes:
        raise ValueError("disjoint_embeddings() needs at least one guest shape")
    for J, L in shapes:
        if J > host.K or L > host.M:
            raise ValueError(
                f"guest D3({J},{L}) does not fit host D3({host.K},{host.M})"
            )
    if sum(J for J, _ in shapes) <= host.K:
        out, c0 = [], 0
        for J, L in shapes:
            out.append(embed(host, J, L, c_set=range(c0, c0 + J)))
            c0 += J
        return tuple(out)
    if sum(L for _, L in shapes) <= host.M:
        out, p0 = [], 0
        for J, L in shapes:
            out.append(embed(host, J, L, p_set=range(p0, p0 + L)))
            p0 += L
        return tuple(out)
    raise ValueError(
        f"guest shapes {shapes} do not pack disjointly into "
        f"D3({host.K},{host.M}): need Σ J ≤ {host.K} or Σ L ≤ {host.M}"
    )


#: above this many poisoned position indices the mixed search switches
#: from exact subset enumeration (2^|bad_p| candidates) to a greedy
#: peel — far beyond any failure pattern the drills inject.
_MIXED_EXACT_LIMIT = 16


def _mixed_candidates(host: D3, dead: set[Router], bad_p: set[int]):
    """The mixed cabinet×position regime: for every kept-position set P,
    the best cabinet set is forced — C must exclude exactly the cabinets
    that still hold a dead router with BOTH indices inside P (a dead
    (c, d, p) is excluded from C × P × P as soon as d or p leaves P).
    Only positions that appear in ``dead`` are worth dropping, so the
    search enumerates subsets of ``bad_p`` (smallest drops first, so
    equal-sized survivors resolve deterministically toward keeping more
    positions); past ``_MIXED_EXACT_LIMIT`` poisoned indices it degrades
    to a greedy peel of the most-poisoning position."""
    import itertools

    ordered = sorted(bad_p)

    def candidate(drop: tuple[int, ...]):
        p_set = tuple(p for p in range(host.M) if p not in drop)
        if not p_set:
            return None
        kept = set(p_set)
        poisoned = {c for c, d, p in dead if d in kept and p in kept}
        c_set = tuple(c for c in range(host.K) if c not in poisoned)
        if not c_set:
            return None
        return len(c_set) * len(p_set) * len(p_set), c_set, p_set

    if len(ordered) <= _MIXED_EXACT_LIMIT:
        for k in range(1, len(ordered)):  # proper mixed drops only: the
            # empty drop is the pure cabinet regime, the full drop the
            # pure position regime — both already priced by the caller
            for drop in itertools.combinations(ordered, k):
                cand = candidate(drop)
                if cand is not None:
                    yield cand
        return
    # greedy peel: repeatedly drop the position poisoning the most cabinets
    drop: list[int] = []
    remaining = set(ordered)
    while remaining:
        kept = {p for p in range(host.M) if p not in drop}

        def poisoners(q):
            k = kept - {q}
            return len({c for c, d, p in dead if d in k and p in k})

        worst = min(remaining, key=lambda q: (poisoners(q), q))
        drop.append(worst)
        remaining.discard(worst)
        if len(drop) < len(ordered):  # proper mixed drops only (see above)
            cand = candidate(tuple(drop))
            if cand is not None:
                yield cand


def largest_embeddable(host: D3, dead: set[Router]) -> tuple[int, int, tuple, tuple]:
    """Survivor-set search over the drop regimes of Property 2; returns
    (J, L, c_set, p_set) with n = J·L² maximal among them.

    A dead router (c, d, p) is excluded from the C × P × P image iff its
    cabinet leaves C or one of its (d, p) indices leaves P, so two pure
    regimes always work:

      * *cabinet-drop*: remove every cabinet containing a dead router —
        survivors D3(K − |bad_c|, M), best for failures clustered in few
        cabinets;
      * *position-drop*: remove every position index a dead router poisons
        (both its d and its p) — survivors D3(K, M − |bad_p|), best for
        failures striped across many cabinets at few (d, p) indices.

    Failures striped across SOME cabinets at SOME positions are a
    set-cover problem the *mixed* regime solves: drop a subset of the
    poisoned positions AND the cabinets the surviving position set still
    can't clear (``_mixed_candidates`` — exact for realistic failure
    counts, greedy beyond ``_MIXED_EXACT_LIMIT`` poisoned indices). All
    candidates are priced together; ties go cabinet-drop > position-drop
    > mixed, so the mixed survivor is returned exactly when it strictly
    dominates both pure regimes (keeping drawers whole otherwise).
    """
    bad_c = {r[0] for r in dead}
    bad_p = {r[1] for r in dead} | {r[2] for r in dead}
    cab_c = tuple(c for c in range(host.K) if c not in bad_c)
    pos_p = tuple(p for p in range(host.M) if p not in bad_p)
    candidates: list[tuple[int, int, tuple, tuple]] = []
    if cab_c:
        candidates.append((len(cab_c) * host.M * host.M, 0,
                           cab_c, tuple(range(host.M))))
    if pos_p:
        candidates.append((host.K * len(pos_p) * len(pos_p), 1,
                           tuple(range(host.K)), pos_p))
    if bad_c and bad_p:  # a mixed drop can only win when both axes hurt
        best_mixed = None
        for size, c_set, p_set in _mixed_candidates(host, dead, bad_p):
            if best_mixed is None or size > best_mixed[0]:
                best_mixed = (size, 2, c_set, p_set)
        if best_mixed is not None:
            candidates.append(best_mixed)
    if not candidates:
        raise RuntimeError("no embeddable subnetwork survives")
    _, _, c_set, p_set = max(candidates, key=lambda t: (t[0], -t[1]))
    return len(c_set), len(p_set), c_set, p_set
