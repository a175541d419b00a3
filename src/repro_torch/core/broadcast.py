"""Broadcast Swapped Dragonfly — paper §5.

Depth-3 spanning tree rooted at (c, d, p)  (header [3; *, *, *]):

    (c,d,p) --L--> (c,d,*) --G--> (*,*,d) --L--> (*,*,*)

Depth-4 spanning trees (header [4; *, *, *]) — M of them per drawer,
rooted at the M routers (c, d, p) of drawer (c, d):

    (c,d,p) --G--> (*,p,d) --L--> (*,p,*) --Z--> (*,*,p) --L--> (*,*,*)

(The paper prints the first hop's destination as (*,d,p); the global hop
swaps (d,p), so the reachable set is (*,p,d) — transcription fixed here,
the rest of §5 is consistent with this.) The M trees are edge-disjoint in
the DIRECTED sense (tree_p and tree_{p'} traverse the Z-link pair
{(x,p,p'),(x,p',p)} in opposite directions — full duplex, the standard
Dragonfly link model; all other stages use disjoint drawers/sources).

M simultaneous broadcasts from one source (c,d,q): delegate
(c,d,q) --L--> (c,d,p) ∀p, then each p runs tree_p: 5 hops total,
[t_s + 5 t_w] when routers duplicate packets.

Pipelining X >> M broadcasts: chaining depth-4 trees back-to-back at
offset 1 conflicts on the Z stage (paper's diagram), so trees chain in
PAIRS — 2 waves of M broadcasts every 6 hops — total cost 3X/M router
hops, vs X hops for the (single) depth-3 tree pipeline: the M-tree
schedule wins by M/3.

Contract owed to the paper — §5. Round count: one depth-3 tree spans all
n routers in 3 hop steps (an M-broadcast in 5, delegation included);
``pipelined_m_broadcast_schedule`` chains wave pairs so X broadcasts cost
3X/M rounds. Conflict-freedom invariant: the M depth-4 trees are
edge-disjoint in the DIRECTED sense (full-duplex Z links), so each wave's
hops — and, after pair-chaining, the overlapped waves — replay through
``core.simulator.verify`` with zero conflicts (asserted in
tests/test_core_broadcast.py).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.topology import D3, Router
from repro_torch.core.simulator import Simulator, Conflict
from repro_torch.core.routing import SyncHeader, STAR, expand_broadcast
from repro_torch.core.schedule import Schedule, hop_round


Hop = tuple[int, Router, Router]  # (step, src, dst)


def depth3_tree(topo: D3, root: Router) -> list[Hop]:
    """L, G, L — 3 steps."""
    c, d, p = root
    hops: list[Hop] = []
    lvl1 = [(c, d, q) for q in range(topo.M)]
    for r in lvl1:
        if r != root:
            hops.append((0, root, r))
    lvl2 = []
    for r in lvl1:
        for g in range(topo.K):
            dst = topo.global_hop(r, g)
            if dst != r:
                hops.append((1, r, dst))
            lvl2.append(dst)
    for r in set(lvl2):
        for q in range(topo.M):
            dst = (r[0], r[1], q)
            if dst != r:
                hops.append((2, r, dst))
    return hops


def depth4_tree(topo: D3, root: Router) -> list[Hop]:
    """G, L, Z, L — 4 steps; root (c,d,p) owns "color" p."""
    c, d, p = root
    hops: list[Hop] = []
    lvl1 = []
    for g in range(topo.K):
        dst = topo.global_hop(root, g)  # (c+g, p, d)
        if dst != root:
            hops.append((0, root, dst))
        lvl1.append(dst)
    lvl2 = []
    for r in set(lvl1):
        for q in range(topo.M):
            dst = (r[0], r[1], q)  # (x, p, *)
            if dst != r:
                hops.append((1, r, dst))
            lvl2.append(dst)
    lvl3 = []
    for r in set(lvl2):
        dst = topo.global_hop(r, 0)  # Z: (x, p, y) -> (x, y, p)
        if dst != r:
            hops.append((2, r, dst))
        lvl3.append(dst)
    for r in set(lvl3):
        for q in range(topo.M):
            dst = (r[0], r[1], q)
            if dst != r:
                hops.append((3, r, dst))
    return hops


def tree_covers(topo: D3, root: Router, hops: list[Hop]) -> bool:
    reached = {root} | {dst for _, _, dst in hops}
    return len(reached) == topo.num_routers


def m_broadcast(topo: D3, source: Router) -> list[Hop]:
    """Delegation + M depth-4 trees: M distinct broadcasts in 5 steps.
    Packet identity = tree color p (the delegate position)."""
    c, d, q = source
    hops: list[Hop] = []
    for p in range(topo.M):
        if (c, d, p) != source:
            hops.append((0, source, (c, d, p)))
        for step, a, b in depth4_tree(topo, (c, d, p)):
            hops.append((step + 1, a, b))
    return hops


def directed_edge_disjoint(trees: list[list[Hop]]) -> bool:
    seen: set[tuple[Router, Router]] = set()
    for t in trees:
        for _, a, b in t:
            if (a, b) in seen:
                return False
            seen.add((a, b))
    return True


def check_m_broadcast(topo: D3, source: Router) -> list[Conflict]:
    """Replay the delegation + M-tree schedule with per-tree packet ids."""
    sim = Simulator(topo)
    c, d, q = source
    for p in range(topo.M):
        if (c, d, p) != source:
            sim.add_hop(0, source, (c, d, p), packet=p)
        for step, a, b in depth4_tree(topo, (c, d, p)):
            sim.add_hop(step + 1, a, b, packet=p)
    return sim.conflicts()


# ---------------------------------------------------------------------------
# Schedule IR emitters — the §5 trees as unified, lowerable schedules.
# ---------------------------------------------------------------------------

def depth3_schedule(topo: D3, root: Router) -> Schedule:
    """One broadcast through the depth-3 tree as a single 3-step round.
    Payload = ("bcast", root) — one packet duplicated down the tree."""
    tag = ("bcast", topo.router_id(root))
    rnd = hop_round(
        [(step, a, b, tag) for step, a, b in depth3_tree(topo, root)],
        meta={"root": root, "tree": "depth3"},
    )
    return Schedule("broadcast_depth3", topo, [rnd], meta={"root": root})


def m_broadcast_schedule(topo: D3, source: Router) -> Schedule:
    """Delegation + M edge-disjoint depth-4 trees as one 5-step round;
    payload = tree color p, so the verifier sees M distinct packets."""
    c, d, q = source
    hops = []
    for p in range(topo.M):
        if (c, d, p) != source:
            hops.append((0, source, (c, d, p), p))
        for step, a, b in depth4_tree(topo, (c, d, p)):
            hops.append((step + 1, a, b, p))
    rnd = hop_round(hops, meta={"source": source, "tree": "m_depth4"})
    return Schedule("broadcast_m_tree", topo, [rnd], meta={"source": source})


def pipelined_m_broadcast_schedule(topo: D3, source: Router, waves: int) -> Schedule:
    """X = waves·M broadcasts, waves pair-chained every 6 steps (2 waves of
    M broadcasts per 6 hops => 3X/M makespan). One IR round per wave with
    ``meta["start_step"]`` carrying the launch offset; replay with
    ``verify(..., pipelined=True)``."""
    c, d, q = source
    rounds = []
    for w in range(waves):
        base = (w // 2) * 6 + (w % 2)  # pair members offset by 1
        hops = []
        for p in range(topo.M):
            pid = w * topo.M + p
            if (c, d, p) != source:
                hops.append((0, source, (c, d, p), pid))
            for step, a, b in depth4_tree(topo, (c, d, p)):
                hops.append((step + 1, a, b, pid))
        rounds.append(hop_round(hops, meta={"start_step": base, "wave": w}))
    return Schedule(
        "broadcast_m_tree_pipelined", topo, rounds,
        meta={"source": source, "waves": waves, "X": waves * topo.M},
    )


# ---------------------------------------------------------------------------
# Pipelined broadcast waves (X >> M).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BroadcastPipelineReport:
    num_broadcasts: int
    total_steps: int
    conflicts: int

    @property
    def steps_per_broadcast(self) -> float:
        return self.total_steps / self.num_broadcasts


def pipeline_depth3(topo: D3, root: Router, X: int) -> BroadcastPipelineReport:
    """Depth-3 tree chained at offset 1 (conflict-free iff p != d)."""
    sim = Simulator(topo)
    tree = depth3_tree(topo, root)
    for w in range(X):
        for step, a, b in tree:
            sim.add_hop(step + w, a, b, packet=w)
    return BroadcastPipelineReport(X, sim.num_steps, len(sim.conflicts()))


def pipeline_depth4_pairs(topo: D3, source: Router, waves: int) -> BroadcastPipelineReport:
    """Pairs of M-broadcast waves chained every 6 steps (paper: 2 waves of
    M broadcasts / 6 hops => 3X/M). ``waves`` is the number of M-broadcast
    waves; X = waves * M broadcasts total."""
    sim = Simulator(topo)
    wave = m_broadcast(topo, source)
    for w in range(waves):
        base = (w // 2) * 6 + (w % 2) * 1  # pair members offset by 1
        for step, a, b in wave:
            sim.add_hop(base + step, a, b, packet=w * topo.M + (0 if a != source else 0))
    # packet ids must separate colors within a wave for conflict accounting
    sim2 = Simulator(topo)
    c, d, q = source
    for w in range(waves):
        base = (w // 2) * 6 + (w % 2) * 1
        for p in range(topo.M):
            pid = w * topo.M + p
            if (c, d, p) != source:
                sim2.add_hop(base, source, (c, d, p), packet=pid)
            for step, a, b in depth4_tree(topo, (c, d, p)):
                sim2.add_hop(base + step + 1, a, b, packet=pid)
    X = waves * topo.M
    return BroadcastPipelineReport(X, sim2.num_steps, len(sim2.conflicts()))


# ---------------------------------------------------------------------------
# Header-driven executor: verifies the router program [b; γ, π, δ] is
# position-independent — replaying ONLY the automaton reproduces the trees.
# ---------------------------------------------------------------------------

def run_header_broadcast(topo: D3, root: Router, header: SyncHeader) -> tuple[set[Router], int]:
    """Flood from root following the synchronized header; returns
    (covered routers, steps)."""
    frontier: list[tuple[Router, SyncHeader]] = [(root, header)]
    covered = {root}
    steps = 0
    while frontier:
        nxt: list[tuple[Router, SyncHeader]] = []
        advanced = False
        for r, h in frontier:
            if h.arrived:
                continue
            kind, port, h2 = h.step()
            targets = expand_broadcast(topo, r, kind, port)
            advanced = True
            if port == STAR or not targets:
                # broadcasting routers remain members of the next level
                # (the tree keeps a copy at the sender); degenerate
                # point-to-point hops stay put with the header advanced.
                nxt.append((r, h2))
            for t in targets:
                covered.add(t)
                nxt.append((t, h2))
        if advanced:
            steps += 1
        frontier = nxt
    return covered, steps
