"""Swapped Boolean Hypercube SBH(k, m) ⊂ D3(2^k, 2^m) — paper §4.

D3(2^k, 2^m) built over ⊕(Z mod 2) groups (XOR arithmetic). SBH(k,m) has
2^(k+2m) nodes (c, d, p); its links are the D3 links actually used by the
hypercube emulation:

  * π_i : (c,d,p) <-> (c,d,p^e_i)       local, flip bit i of p
  * γ_i : (c,d,p) <-> (c^e_i, p, d)     global, flip bit i of c (+swap)
  * Z   : (c,d,p) <-> (c,p,d)           global port 0 (absent when d == p)

Emulated (k+2m)-cube dimension exchange paths (dilation ≤ 3, avg < 2):

  c-bit i:  γ_i, Z                    (dilation 2; 1 when d == p)
  d-bit i:  Z, π_i, Z                 (dilation 3; Z∘π_i = 2 when d == p)
  p-bit i:  π_i                       (dilation 1)

With the synchronized header (§5) all three become uniform 4-step paths:
  c = [4; γ, 0, 0],  d = [4; 0, 0, δ],  p = [4; 0, π, 0].

Ascend–descend algorithms (all-reduce, FFT, bitonic steps) traverse the
k+2m dimensions in order; the emulation costs Σ dilations = 2(k+2m) hops,
i.e. 2× the hypercube — the paper's headline factor-2 claim.

Contract owed to the paper — §4, Theorem 4. Round count:
``allreduce_schedule(sbh)`` emits k+2m dimension-exchange rounds whose
emulated hop total is at most 2(k+2m) (``hypercube_cost``, dilation ≤ 3
per dimension, ≤ 2 on average). Conflict-freedom invariant: within each
dimension round every node pair exchanges along its emulation path with
zero directed-link conflicts — ``core.simulator.verify`` must agree
(asserted in tests/test_core_hypercube.py and test_schedule_ir.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.topology import D3, Router
from repro_torch.core.simulator import Simulator, Conflict
from repro_torch.core.routing import SyncHeader, header_trace
from repro_torch.core.schedule import Schedule, path_round


@dataclasses.dataclass(frozen=True)
class SBH:
    k: int
    m: int

    @property
    def topo(self) -> D3:
        return D3(1 << self.k, 1 << self.m)

    @property
    def dims(self) -> int:
        return self.k + 2 * self.m

    @property
    def num_nodes(self) -> int:
        return 1 << self.dims

    # -------------------------------------------------- node <-> bit string
    def node(self, x: int) -> Router:
        """x is a (k+2m)-bit integer: c = high k bits, d = middle m, p = low m."""
        mask_m = (1 << self.m) - 1
        p = x & mask_m
        d = (x >> self.m) & mask_m
        c = x >> (2 * self.m)
        return (c, d, p)

    def index(self, r: Router) -> int:
        c, d, p = r
        return (c << (2 * self.m)) | (d << self.m) | p

    # --------------------------------------------------------- XOR-hop ops
    def local_xor(self, r: Router, bits: int) -> Router:
        c, d, p = r
        return (c, d, p ^ bits)

    def global_xor(self, r: Router, bits: int) -> Router:
        """Global port 'bits' under XOR arithmetic; bits == 0 is Z."""
        c, d, p = r
        return (c ^ bits, p, d)

    def field_of(self, dim: int) -> str:
        """Which coordinate field cube-dimension ``dim`` lives in."""
        if dim < self.m:
            return "p"
        if dim < 2 * self.m:
            return "d"
        return "c"

    def emulation_path(self, r: Router, dim: int) -> list[Router]:
        """Routers visited flipping cube-dimension ``dim`` from node r
        (the dilation-≤3 paths of §4, including the d == p special cases)."""
        c, d, p = r
        f = self.field_of(dim)
        if f == "p":
            return [r, self.local_xor(r, 1 << dim)]
        if f == "d":
            bit = 1 << (dim - self.m)
            if d == p:  # Z at the source is a self-loop: π_i then Z
                a = self.local_xor(r, bit)  # (c, d, d^bit)
                return [r, a, self.global_xor(a, 0)]  # (c, d^bit, d)
            a = self.global_xor(r, 0)  # (c, p, d)
            b = self.local_xor(a, bit)  # (c, p, d^bit)
            z = self.global_xor(b, 0)
            # if p == d^bit the trailing Z is a self-loop (b is already the
            # destination (c, d^bit, p) with swapped-equal coords): elide.
            return [r, a, b] if z == b else [r, a, b, z]
        bit = 1 << (dim - 2 * self.m)
        a = self.global_xor(r, bit)  # (c^bit, p, d)
        if d == p:
            return [r, a]  # swap is identity
        return [r, a, self.global_xor(a, 0)]

    def dilation(self, r: Router, dim: int) -> int:
        return len(self.emulation_path(r, dim)) - 1

    def dilation_stats(self) -> tuple[int, float]:
        """(max, average) dilation over all (node, dim) pairs."""
        worst = 0
        total = 0
        count = 0
        for x in range(self.num_nodes):
            r = self.node(x)
            for dim in range(self.dims):
                dil = self.dilation(r, dim)
                worst = max(worst, dil)
                total += dil
                count += 1
        return worst, total / count

    # ------------------------------------------- uniform dilation-4 headers
    def sync_header(self, dim: int) -> SyncHeader:
        """§5: c = [4; γ,0,0], d = [4; 0,0,δ], p = [4; 0,π,0]."""
        f = self.field_of(dim)
        if f == "c":
            return SyncHeader(4, 1 << (dim - 2 * self.m), 0, 0)
        if f == "d":
            return SyncHeader(4, 0, 0, 1 << (dim - self.m))
        return SyncHeader(4, 0, 1 << dim, 0)

    def sync_path(self, r: Router, dim: int) -> list[Router]:
        """Replay the header automaton from r under XOR arithmetic (D3 over
        ⊕Z_2 groups); returns visited routers. Degenerate steps (port 0)
        stay in place but still consume a synchronized step — that is the
        point of the uniform dilation-4 emulation."""
        path = [r]
        h = self.sync_header(dim)
        cur = r
        while not h.arrived:
            kind, port, h = h.step()
            assert isinstance(port, int)
            cur = self.local_xor(cur, port) if kind == "local" else self.global_xor(cur, port)
            path.append(cur)
        return path


# ---------------------------------------------------------------------------
# Ascend–descend: recursive-doubling all-reduce over the emulated cube.
# ---------------------------------------------------------------------------

def allreduce_rounds(sbh: SBH) -> list[list[tuple[Router, Router]]]:
    """One round per cube dimension; each round exchanges along that
    dimension via the emulation path (both directions simultaneously —
    links are full-duplex). Returns per-dimension lists of directed
    (src, dst) *endpoint* pairs; hop expansion happens in the simulator
    via emulation_path."""
    out = []
    for dim in range(sbh.dims):
        pairs = []
        for x in range(sbh.num_nodes):
            r = sbh.node(x)
            pairs.append((r, sbh.emulation_path(r, dim)[-1]))
        out.append(pairs)
    return out


def allreduce_schedule(sbh: SBH) -> Schedule:
    """Ascend–descend all-reduce as a unified ``Schedule``: one round per
    cube dimension, hops expanded from the dilation-≤3 emulation paths
    (payload = node index), ``meta["pairs"]`` holding the endpoint exchange
    permutation (an involution) the runtime lowers to one ppermute+add.
    Barrier makespan = Σ max-dilation = 2(k+2m) — the factor-2 claim."""
    topo = sbh.topo
    rounds = []
    for dim in range(sbh.dims):
        paths = []
        pairs = []
        for x in range(sbh.num_nodes):
            path = sbh.emulation_path(sbh.node(x), dim)
            paths.append((path, x))
            pairs.append((x, sbh.index(path[-1])))
        rounds.append(
            path_round(paths, meta={"dim": dim, "pairs": tuple(pairs),
                                    "field": sbh.field_of(dim)})
        )
    return Schedule(
        "sbh_allreduce", topo, rounds,
        meta={"k": sbh.k, "m": sbh.m, "dims": sbh.dims},
    )


def check_allreduce_conflicts(sbh: SBH) -> tuple[list[Conflict], int]:
    """Replay the full ascend all-reduce; every dimension-round expands to
    its (≤3)-hop emulation paths, packets advance one hop per step.
    Returns (conflicts, total_steps)."""
    total_steps = 0
    all_conflicts: list[Conflict] = []
    for dim in range(sbh.dims):
        sim = Simulator(sbh.topo)
        max_len = 0
        for pkt, x in enumerate(range(sbh.num_nodes)):
            path = sbh.emulation_path(sbh.node(x), dim)
            sim.add_path(0, path, pkt)
            max_len = max(max_len, len(path) - 1)
        all_conflicts.extend(sim.conflicts())
        total_steps += max_len
    return all_conflicts, total_steps


def simulate_allreduce(sbh: SBH, values: np.ndarray) -> np.ndarray:
    """values[x] per node; returns the all-reduced (sum) vector — verifies
    the ascend algorithm's data movement is a correct all-reduce."""
    vals = values.astype(np.float64).copy()
    for dim in range(sbh.dims):
        nxt = vals.copy()
        for x in range(sbh.num_nodes):
            partner = sbh.index(sbh.emulation_path(sbh.node(x), dim)[-1])
            nxt[x] = vals[x] + vals[partner]
        vals = nxt
    return vals


def hypercube_cost(sbh: SBH) -> tuple[int, int]:
    """(emulated cost in hops, native (k+2m)-cube cost) for one ascend."""
    emulated = sum(
        max(sbh.dilation(sbh.node(x), dim) for x in range(sbh.num_nodes))
        for dim in range(sbh.dims)
    )
    return emulated, sbh.dims
