"""Source-vector routing and the synchronized broadcast header.

A source vector (γ, π, δ) at router (c, d, p) produces the 3-hop path

    (c,d,p) --δ(local)--> (c,d,p+δ) --γ(global)--> (c+γ, p+δ, d)
            --π(local)--> (c+γ, p+δ, d+π)

i.e. an l-g-l path. Degenerate ports (δ=0 local, π=0 local, γ=0 with d==p
after the swap would be a self-loop) consume no link.

The destination of (γ,π,δ) from (c,d,p) is (c+γ, p+δ, d+π): the unique
vector delivering from src=(c,d,p) to dst=(c',d',p') is

    γ = c' - c,   δ = d' - p,   π = p' - d      (mod K / M / M)

Synchronized header [b; γ, π, δ] (paper §5): a router program independent
of position in the spanning tree:

  * b odd  : use local port δ;  b -= 1;  δ <- π;  π <- 0
  * b even : use global port γ; b -= 1;  γ <- 0
  * b == 0 : arrived.

With broadcast semantics a '*' port means "all ports" (local broadcast over
the drawer / global broadcast over all K offsets).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.topology import D3, Router

Vector = tuple[int, int, int]  # (gamma, pi, delta)

# Sentinel for "broadcast over all ports" in a synchronized header.
STAR = "*"


def vector_for(topo: D3, src: Router, dst: Router) -> Vector:
    """The unique source vector routing src -> dst (paper §1)."""
    c, d, p = src
    c2, d2, p2 = dst
    gamma = (c2 - c) % topo.K
    delta = (d2 - p) % topo.M
    pi = (p2 - d) % topo.M
    return (gamma, pi, delta)


def vector_dest(topo: D3, src: Router, vec: Vector) -> Router:
    gamma, pi, delta = vec
    c, d, p = src
    return ((c + gamma) % topo.K, (p + delta) % topo.M, (d + pi) % topo.M)


def vector_path(topo: D3, src: Router, vec: Vector) -> list[Router]:
    """Routers visited by the l-g-l path, including src. Degenerate hops
    (those that would stay on the same router) are elided — they use no
    link, matching the paper's hop accounting."""
    gamma, pi, delta = vec
    path = [src]
    r = topo.local_hop(src, delta)
    if r != path[-1]:
        path.append(r)
    r2 = topo.global_hop(path[-1], gamma)
    if r2 != path[-1]:
        path.append(r2)
    r3 = topo.local_hop(path[-1], pi)
    if r3 != path[-1]:
        path.append(r3)
    return path


def path_links(path: list[Router]) -> list[tuple[Router, Router]]:
    return [(path[i], path[i + 1]) for i in range(len(path) - 1)]


# --------------------------------------------------------------------------
# Synchronized header automaton (§5) — the "Broadcast Swapped Dragonfly".
# --------------------------------------------------------------------------

Port = int | str  # an int offset, or STAR


@dataclasses.dataclass(frozen=True)
class SyncHeader:
    """Header [b; γ, π, δ]. Interpreted identically by every router."""

    b: int
    gamma: Port
    pi: Port
    delta: Port

    def step(self) -> tuple[str, Port, "SyncHeader"]:
        """One router interpretation step.

        Returns (kind, port, next_header) where kind is 'local'|'global'.
        Raises if b == 0 (already arrived).
        """
        if self.b <= 0:
            raise ValueError("packet already arrived (b == 0)")
        if self.b % 2 == 1:  # odd -> local port delta; delta <- pi; pi <- 0
            return ("local", self.delta, SyncHeader(self.b - 1, self.gamma, 0, self.pi))
        # even -> global port gamma; gamma <- 0
        return ("global", self.gamma, SyncHeader(self.b - 1, 0, self.pi, self.delta))

    @property
    def arrived(self) -> bool:
        return self.b == 0


def header_trace(header: SyncHeader) -> list[tuple[str, Port]]:
    """Full evolution of a (non-broadcast) header to arrival."""
    out = []
    h = header
    while not h.arrived:
        kind, port, h = h.step()
        out.append((kind, port))
    return out


def expand_broadcast(topo: D3, r: Router, kind: str, port: Port) -> list[Router]:
    """Expand one header step at router r into next-hop routers.

    STAR on a local step = all M-1 drawer peers (plus staying is not a hop);
    STAR on a global step = all K global offsets (offset 0 kept unless it is
    a self-loop). An int port is a single hop; a degenerate hop (self-loop)
    yields [] (packet stays, no link used).
    """
    if kind == "local":
        if port == STAR:
            c, d, p = r
            return [(c, d, q) for q in range(topo.M) if q != p]
        nxt = topo.local_hop(r, port)  # type: ignore[arg-type]
        return [nxt] if nxt != r else []
    assert kind == "global"
    if port == STAR:
        out = []
        for g in range(topo.K):
            nxt = topo.global_hop(r, g)
            if nxt != r:
                out.append(nxt)
        return out
    nxt = topo.global_hop(r, port)  # type: ignore[arg-type]
    return [nxt] if nxt != r else []
