"""Matrix product on D3(K², M) — paper §2, Theorems 1 and 2.

Storage (paper §2): D3(K²,M) is viewed as a K×K array of M×M blocks with
index set (s, t, u, v), 0 ≤ s,t < K, 0 ≤ u,v < M, assigned to router
(c, d, p) = (s + t·K, u, v). For a KM×KM matrix, (s, u) is the ROW index
pair and (t, v) the COLUMN index pair:

    A[row=(s,u), col=(t,v)]  lives at router  (s + t·K, u, v).

A row vector V "at (s,u)" stores element (t, v) at (s + t·K, u, v).

Vector-matrix multiply, one round of four hops + two off-and-ons:

 Phase 1 (juxtaposition, paper path 2.1/2.2 — g then l):
    V_{t,v} at (s+tK, u, v)  --g-->  (t+t'K, v, u) ∀t'  --l-->  (t+t'K, v, v') ∀v'
 so V_{t,v} meets row (t,v) of A at every (t', v'); products
 P_{(t,v),(t',v')} = V_{t,v}·A[(t,v),(t',v')] form on (t+t'K, v, v').

 Phase 2 (accumulation). ERRATUM (documented in DESIGN.md/EXPERIMENTS.md):
 the paper's path 2.3 literally reverses 2.2, which converges the KM
 products sharing the SAME factor V_{t,v} (a row-sum), not the products
 contributing to one output element. We implement the mirror reduction
 that preserves the claimed structure (2 hops, 2 accumulations, zero
 conflicts): for output element (t', v'), contributors (t+t'K, v, v')
 over all (t, v) converge

    (t+t'K, v, v')  --g(γ = S - t)-->  (S+t'K, v', v)   [K values sum over t]
                    --l(v -> u)    -->  (S+t'K, v', u)   [M sums sum over v]

 landing output element (t',v') on router (S+t'K, v', u) — the Z-swap
 (d ↔ p) of the row-vector layout "at (S, u)". S = s gives the in-place
 variant (up to the Z-swap, fixable with one global-0 hop, or consumed
 directly by the next round's mirrored phase-1); S ≠ s gives the
 out-of-place variant the paper mentions ("modifying s and u").

A KM×KM matrix product is KM such rounds (one per row (s,u) of the left
matrix), each 4 network hops — Theorem 1. For n×n with X = n/KM, every
router holds X×X blocks and each round moves X-vectors; n²/KM rounds —
Theorem 2 (the X×X block product is the off-network compute, realized in
the runtime by the batched block-product CUDA kernel).

Contract owed to the paper — §2, Theorems 1 and 2. Round count:
``schedule(g)`` emits KM rounds (one per row (s, u) of the left matrix),
each 4 network hops + 2 off-and-ons; ``rounds_for(g, n)`` = n²/KM for
X-blocked operands. Conflict-freedom invariant: every round's
juxtaposition and mirrored-accumulation hops occupy pairwise-distinct
directed links of D3(K², M) — ``core.simulator.verify`` must report zero
conflicts (asserted in tests/test_core_matmul.py and, per Property 2,
preserved verbatim under every ``runtime.rewrite`` / ``runtime.combine``
relabeling).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.topology import D3, Router
from repro_torch.core.simulator import Simulator, Conflict
from repro_torch.core.schedule import Schedule, Round, hop_round


@dataclasses.dataclass(frozen=True)
class MatmulGrid:
    """D3(K², M) viewed as a K×K array of M×M blocks."""

    K: int
    M: int

    @property
    def topo(self) -> D3:
        return D3(self.K * self.K, self.M)

    @property
    def n(self) -> int:  # matrix side
        return self.K * self.M

    def router(self, s: int, t: int, u: int, v: int) -> Router:
        return ((s + t * self.K) % (self.K * self.K), u % self.M, v % self.M)

    def element_home(self, row: tuple[int, int], col: tuple[int, int]) -> Router:
        (s, u), (t, v) = row, col
        return self.router(s, t, u, v)

    def rc(self, i: int) -> tuple[int, int]:
        """Matrix index i in 0..KM-1 -> (block, offset) = (t, v)."""
        return divmod(i, self.M)


def vector_matmul_phases(
    g: MatmulGrid, s: int, u: int, S: int | None = None
) -> list[list[tuple[Router, Router]]]:
    """Directed hops of the 4 phases of one round (row (s,u), output root S).

    Returns [phase0, phase1, phase2, phase3] where each phase is a list of
    (src, dst) directed hops executed simultaneously.
    """
    if S is None:
        S = s
    K, M = g.K, g.M
    topo = g.topo
    ph0, ph1, ph2, ph3 = [], [], [], []
    for t in range(K):
        for v in range(M):
            src = g.router(s, t, u, v)
            for t2 in range(K):
                c1 = g.router(t, t2, v, u)
                if c1 != src:
                    ph0.append((src, c1))
                for v2 in range(M):
                    leaf = g.router(t, t2, v, v2)
                    if leaf != c1:
                        ph1.append((c1, leaf))
    # phase 2/3: mirror reduction. Contributor (t+t'K, v, v') -> (S+t'K, v', v)
    for t2 in range(K):
        for v2 in range(M):
            for t in range(K):
                for v in range(M):
                    leaf = g.router(t, t2, v, v2)
                    mid = g.router(S, t2, v2, v)
                    if mid != leaf:
                        ph2.append((leaf, mid))
            for v in range(M):
                mid = g.router(S, t2, v2, v)
                root = g.router(S, t2, v2, u)
                if root != mid:
                    ph3.append((mid, root))
    # sanity: every hop is a physical link of the right kind
    for a, b in ph0 + ph2:
        assert topo.is_global_link(a, b), (a, b)
    for a, b in ph1 + ph3:
        assert topo.is_local_link(a, b), (a, b)
    return [ph0, ph1, ph2, ph3]


def round_matchings(
    g: MatmulGrid, s: int, u: int, S: int | None = None
) -> dict[str, object]:
    """The executable partition of one round's 4 phases, in router-ID space —
    the accumulation-combine metadata the runtime lowering consumes.

    The paper's conflict model lets a router drive all its ports at once, so
    a phase is *several* simultaneous matchings on a ppermute backend:

      * ``bcast``  — phase 1/2 (juxtaposition): K global matchings (one per
        destination cabinet offset t') then M-1 local matchings (one per
        destination position v'). Receivers REPLACE their value; identity
        hops are elided (the value is already in place).
      * ``reduce`` — phase 3/4 (mirrored accumulation): K global matchings
        (one per contributor block-row t) then M local matchings (one per
        contributor position v). Receivers COMBINE (sum) arrivals into an
        accumulator; identity pairs are KEPT — they are the local
        contribution of a router to its own sum (an off-and-on, no link).
      * ``zfix``   — one global-0 matching undoing the Z-swap (d ↔ p) of the
        landing layout, the single extra hop the paper notes makes the
        in-place variant truly in place.
      * ``store_mask`` — router ids holding row (s,u) of the output after
        the zfix (the same routers that launched the row of B).

    Each entry is (step, pairs) with step the IR hop step (0..3; zfix = 4).
    """
    if S is None:
        S = s
    K, M = g.K, g.M
    rid = g.topo.router_id
    bcast: list[tuple[int, tuple]] = []
    for t2 in range(K):  # phase 0: global juxtaposition, one matching per t'
        pairs = []
        for t in range(K):
            for v in range(M):
                a, b = g.router(s, t, u, v), g.router(t, t2, v, u)
                if a != b:
                    pairs.append((rid(a), rid(b)))
        bcast.append((0, tuple(pairs)))
    for v2 in range(M):  # phase 1: local fan-out, one matching per v'
        if v2 == u:
            continue  # all-identity matching: the value is already there
        pairs = []
        for t in range(K):
            for t2 in range(K):
                for v in range(M):
                    a, b = g.router(t, t2, v, u), g.router(t, t2, v, v2)
                    pairs.append((rid(a), rid(b)))
        bcast.append((1, tuple(pairs)))
    reduce_: list[tuple[int, tuple]] = []
    for t in range(K):  # phase 2: global converge, one matching per t
        pairs = []
        for t2 in range(K):
            for v in range(M):
                for v2 in range(M):
                    a, b = g.router(t, t2, v, v2), g.router(S, t2, v2, v)
                    pairs.append((rid(a), rid(b)))  # identity = local add
        reduce_.append((2, tuple(pairs)))
    for v in range(M):  # phase 3: local converge, one matching per v
        pairs = []
        for t2 in range(K):
            for v2 in range(M):
                a, b = g.router(S, t2, v2, v), g.router(S, t2, v2, u)
                pairs.append((rid(a), rid(b)))
        reduce_.append((3, tuple(pairs)))
    zfix = []
    for t2 in range(K):  # global-0 hop: (S+t'K, v', u) -> (S+t'K, u, v')
        for v2 in range(M):
            a, b = g.router(S, t2, v2, u), g.router(S, t2, u, v2)
            if a != b:
                zfix.append((rid(a), rid(b)))
    store = tuple(
        sorted(rid(g.router(S, t, u, v)) for t in range(K) for v in range(M))
    )
    return {
        "bcast": tuple(bcast),
        "reduce": tuple(reduce_),
        "zfix": (4, tuple(zfix)),
        "store_mask": store,
    }


def round_ir(g: MatmulGrid, s: int, u: int, S: int | None = None) -> Round:
    """One vector-matmul round as an IR ``Round``: the 4 phases become steps
    0..3, payload = hop index within its phase (each phase's hops are
    pairwise link-distinct packets). ``startups=2`` records the two
    off-and-ons the paper charges per round (4 t_w + 2 t_s).
    ``meta["matmul"]`` carries the accumulation-combine partition
    (``round_matchings``) the runtime lowers to Match/ReduceCombine stages;
    the hop list itself stays the paper's 4-step round for verify/price."""
    hops = []
    for phase, phase_hops in enumerate(vector_matmul_phases(g, s, u, S)):
        for pkt, (a, b) in enumerate(phase_hops):
            hops.append((phase, a, b, pkt))
    return hop_round(hops, meta={"row": (s, u), "S": S if S is not None else s,
                                 "startups": 2, "grid": (g.K, g.M),
                                 "matmul": round_matchings(g, s, u, S)})


def schedule(g: MatmulGrid) -> Schedule:
    """Theorem 1: a KM×KM matrix product is KM rounds (one per row (s,u) of
    the left matrix), each 4 network hops — √n rounds on n = (KM)² routers
    is the paper's headline count for the square grid."""
    rounds = [round_ir(g, s, u) for s in range(g.K) for u in range(g.M)]
    return Schedule("matmul_d3", g.topo, rounds, meta={"grid": g, "n": g.n})


def check_round_conflicts(g: MatmulGrid, s: int, u: int) -> list[Conflict]:
    sim = Simulator(g.topo)
    for phase, hops in enumerate(vector_matmul_phases(g, s, u)):
        for pkt, (a, b) in enumerate(hops):
            sim.add_hop(phase, a, b, pkt)
    return sim.conflicts()


def simulate_vector_matmul(
    g: MatmulGrid, V: np.ndarray, A: np.ndarray, s: int, u: int, S: int | None = None
) -> np.ndarray:
    """Execute one round's data movement literally; return V @ A.

    V: (KM,) row vector (logically stored at row home (s,u));
    A: (KM, KM). Output row vector of length KM (gathered from the
    Z-swapped layout for verification).
    """
    if S is None:
        S = s
    K, M, n = g.K, g.M, g.n
    # phase 1: broadcast — value landing on each leaf router
    leaf_val: dict[Router, float] = {}
    for t in range(K):
        for v in range(M):
            val = V[t * M + v]
            for t2 in range(K):
                for v2 in range(M):
                    leaf_val[g.router(t, t2, v, v2)] = val
    # off-and-on #1: multiply by resident A element
    prod: dict[Router, float] = {}
    for t in range(K):
        for v in range(M):
            for t2 in range(K):
                for v2 in range(M):
                    r = g.router(t, t2, v, v2)
                    prod[r] = leaf_val[r] * A[t * M + v, t2 * M + v2]
    # phase 2: global converge, sum over t (off-and-on #2a)
    mid_sum: dict[Router, float] = {}
    for t2 in range(K):
        for v2 in range(M):
            for v in range(M):
                mid = g.router(S, t2, v2, v)
                mid_sum[mid] = sum(
                    prod[g.router(t, t2, v, v2)] for t in range(K)
                )
    # phase 3: local converge, sum over v (off-and-on #2b)
    out = np.zeros(n, dtype=np.result_type(V, A))
    for t2 in range(K):
        for v2 in range(M):
            root = g.router(S, t2, v2, u)
            out[t2 * M + v2] = sum(mid_sum[g.router(S, t2, v2, v)] for v in range(M))
            del root  # root identity checked in tests via layout map
    return out


def simulate_matmul(g: MatmulGrid, B: np.ndarray, A: np.ndarray) -> np.ndarray:
    """KM rounds (one per row (s,u) of B) -> B @ A. Theorem 1."""
    n = g.n
    out = np.zeros((n, n), dtype=np.result_type(B, A))
    for s in range(g.K):
        for u in range(g.M):
            out[s * g.M + u] = simulate_vector_matmul(g, B[s * g.M + u], A, s, u)
    return out


def rounds_for(g: MatmulGrid, n: int) -> int:
    """Theorem 2 round count for an n×n product, n a multiple of KM."""
    if n % g.n:
        raise ValueError("n must be a multiple of K*M")
    return n * n // g.n


def network_time(g: MatmulGrid, n: int, t_w: float = 1.0, t_s: float = 0.0) -> float:
    """Per paper: each round is 4 t_w + 2 t_s."""
    return rounds_for(g, n) * (4 * t_w + 2 * t_s)


# ---------------------------------------------------------------------------
# Block layout: matrix <-> per-router blocks (the storage map of §2).
# ---------------------------------------------------------------------------

def block_of_router(g: MatmulGrid, r: Router) -> tuple[int, int]:
    """Router (c, d, p) -> its (block-row, block-col) = (sM+u, tM+v) with
    s = c mod K, t = c div K, u = d, v = p."""
    c, d, p = r
    return (c % g.K) * g.M + d, (c // g.K) * g.M + p


def scatter_blocks(g: MatmulGrid, mat: np.ndarray) -> np.ndarray:
    """(N·X, N·X) matrix -> (n_routers, X, X) blocks in router-id order."""
    N = g.n
    if mat.shape[0] % N or mat.shape[1] % N or mat.shape[0] != mat.shape[1]:
        raise ValueError(f"matrix side must be a multiple of N={N}: {mat.shape}")
    X = mat.shape[0] // N
    out = np.empty((g.topo.num_routers, X, X), mat.dtype)
    for r in g.topo.routers():
        i, j = block_of_router(g, r)
        out[g.topo.router_id(r)] = mat[i * X:(i + 1) * X, j * X:(j + 1) * X]
    return out


def gather_blocks(g: MatmulGrid, blocks: np.ndarray) -> np.ndarray:
    """(n_routers, X, X) blocks in router-id order -> (N·X, N·X) matrix."""
    X = blocks.shape[1]
    N = g.n
    out = np.empty((N * X, N * X), blocks.dtype)
    for r in g.topo.routers():
        i, j = block_of_router(g, r)
        out[i * X:(i + 1) * X, j * X:(j + 1) * X] = blocks[g.topo.router_id(r)]
    return out
