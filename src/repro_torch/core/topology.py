"""Swapped Dragonfly topology D3(K, M).

The Swapped Dragonfly (Draper, arXiv:2202.01843) has K*M^2 routers with
coordinates (c mod K, d mod M, p mod M):

  * ``c`` — cabinet (group of drawers sharing a global-port color),
  * ``d`` — drawer within the cabinet,
  * ``p`` — position (router) within the drawer.

Connectivity::

    local :  (c, d, p) <->  (c, d, p')        for all p' != p
    global:  (c, d, p) <->  (c + g, p, d)     for all g  (note the d/p swap)

Local links form a complete graph K_M inside each drawer. The global link
with offset ``g`` (a *global port*) leaves cabinet ``c`` for cabinet
``c + g`` and lands on the router whose (d, p) are the *swap* of the
sender's. Global offset g = 0 is the "Z" link (c, d, p) <-> (c, p, d).

This module is the ground-truth graph: every schedule produced by the
algorithm modules (matmul / alltoall / hypercube / broadcast) is replayed
on this graph by ``core.simulator`` to prove the paper's conflict-freedom
and round-count claims.

Link identity
-------------
A *link* is an undirected physical resource; a *hop* is a directed
traversal. The paper's conflict model is: within one round, a directed
link (an ordered pair of adjacent routers) may be used by at most one
packet. Bidirectional links carry one packet each way simultaneously
(standard full-duplex assumption; the paper's Property 1 permutation
argument requires it). We therefore key conflicts on directed edges.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator

Router = tuple[int, int, int]  # (c, d, p)
DirectedLink = tuple[Router, Router]


@dataclasses.dataclass(frozen=True)
class D3:
    """The Swapped Dragonfly D3(K, M)."""

    K: int
    M: int

    def __post_init__(self) -> None:
        if self.K < 1 or self.M < 1:
            raise ValueError(f"D3 requires K >= 1, M >= 1, got {self.K}, {self.M}")

    # ------------------------------------------------------------------ size
    @property
    def num_routers(self) -> int:
        return self.K * self.M * self.M

    @property
    def num_local_links(self) -> int:
        # K*M drawers, each a complete graph on M routers.
        return self.K * self.M * (self.M * (self.M - 1) // 2)

    @property
    def num_global_links(self) -> int:
        # Each router has K global ports (offsets 0..K-1); offset 0 with
        # d == p is a self-loop which we do not count. Undirected count:
        # pairs {(c,d,p), (c+g,p,d)}.
        total_directed = 0
        for g in range(self.K):
            for c, d, p in self.routers():
                dst = ((c + g) % self.K, p, d)
                if dst != (c, d, p):
                    total_directed += 1
        return total_directed // 2

    # --------------------------------------------------------------- routers
    def routers(self) -> Iterator[Router]:
        for c in range(self.K):
            for d in range(self.M):
                for p in range(self.M):
                    yield (c, d, p)

    def contains(self, r: Router) -> bool:
        c, d, p = r
        return 0 <= c < self.K and 0 <= d < self.M and 0 <= p < self.M

    # ---------------------------------------------------------- router <-> id
    def router_id(self, r: Router) -> int:
        """Linear id: c*M^2 + d*M + p — the device-mesh order used by dist/."""
        c, d, p = r
        assert self.contains(r), r
        return (c * self.M + d) * self.M + p

    def id_router(self, i: int) -> Router:
        p = i % self.M
        d = (i // self.M) % self.M
        c = i // (self.M * self.M)
        assert 0 <= c < self.K, i
        return (c, d, p)

    # ------------------------------------------------------------------ hops
    def local_hop(self, r: Router, delta: int) -> Router:
        """Use local port ``delta`` (offset within the drawer): p -> p+delta."""
        c, d, p = r
        return (c, d, (p + delta) % self.M)

    def global_hop(self, r: Router, gamma: int) -> Router:
        """Use global port ``gamma``: (c,d,p) -> (c+gamma, p, d). Swap d/p."""
        c, d, p = r
        return ((c + gamma) % self.K, p, d)

    def neighbors(self, r: Router) -> list[Router]:
        c, d, p = r
        out = [(c, d, q) for q in range(self.M) if q != p]
        for g in range(self.K):
            dst = self.global_hop(r, g)
            if dst != r:
                out.append(dst)
        return out

    def is_local_link(self, a: Router, b: Router) -> bool:
        return a[0] == b[0] and a[1] == b[1] and a[2] != b[2]

    def is_global_link(self, a: Router, b: Router) -> bool:
        # (c,d,p) -> (c', p, d) for some offset; the swap is the signature.
        return a[1] == b[2] and a[2] == b[1] and (a[0] != b[0] or a[1] != a[2])

    def is_link(self, a: Router, b: Router) -> bool:
        return self.contains(a) and self.contains(b) and (
            self.is_local_link(a, b) or self.is_global_link(a, b)
        )

    # -------------------------------------------------------------- distances
    def shortest_path_len(self, a: Router, b: Router) -> int:
        """BFS shortest-path length (used by tests on small instances)."""
        if a == b:
            return 0
        frontier = {a}
        seen = {a}
        dist = 0
        while frontier:
            dist += 1
            nxt = set()
            for r in frontier:
                for n in self.neighbors(r):
                    if n == b:
                        return dist
                    if n not in seen:
                        seen.add(n)
                        nxt.add(n)
            frontier = nxt
        raise AssertionError("disconnected — impossible for D3 with K,M >= 1")


def directed_link(a: Router, b: Router) -> DirectedLink:
    return (a, b)
