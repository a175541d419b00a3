"""Doubly-parallel all-to-all on D3(ks, ms) — paper §3, Theorem 3.

Construction (K = k*s, M = m*s):

 * In Z_M, s generates the subgroup G = {0, s, ..., (m-1)s} with s cosets
   [t] = t + G. The *dual partition* cells are {a*s, ..., a*s + s-1}
   (one element from each coset, contiguous representatives).
 * A *disagreeable array* (DA) has s columns; column t holds coset [t] in
   its γ row (in Z_K) and cosets [t+μ], [t+ν] (mod s) in its π, δ rows
   (μ, ν are the cyclic left-shifts of the bottom two rows).
 * One round picks a vector from each column at the SAME location
   (c of γ row, a of π row, b of δ row); the s vectors are pairwise
   "disagreeable" (γ≠γ', π≠π', δ≠δ') so all s can be sent by every
   router simultaneously with zero link conflicts (Property 3).
 * Rounds per DA: λ = a + b·m + c·m², 0 ≤ λ < k·m². DAs: φ = μ + ν·s,
   0 ≤ φ < s². Total rounds = s²·k·m² = K·M²/s; every vector
   (γ,π,δ) ∈ Z_K × Z_M × Z_M used exactly once.

Pipelining (Schedules 1..3): start a new round every ``offset`` hops.
Schedule 1 (offset 1) conflicts exactly when the π-offset-set of round i
equals the δ-offset-set of round i+2 (dual cells: a_i == b_{i+2}); the
paper resolves each with a one-hop delay and counts KM delays total. The
simulator below *measures* conflicts for any offset and inserts minimal
delays, so the paper's counts are verified rather than assumed.

Contract owed to the paper — §3, Theorem 3 (+ Property 3, Schedules 1–3).
Round count: ``schedule(p)`` emits exactly K·M²/s rounds
(``DAParams.total_rounds``) covering every vector (γ, π, δ) once
(``verify_vector_coverage``). Conflict-freedom invariant: the s vectors
of one round are pairwise disagreeable, so all s source-vector sends fly
simultaneously with zero directed-link conflicts — and for the pipelined
Schedules 1–3, after the measured delay insertion the overlapped rounds
stay conflict-free under ``verify(pipelined=True)`` (asserted in
tests/test_core_alltoall.py).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

from repro_torch.core.topology import D3
from repro_torch.core.routing import Vector
from repro_torch.core.schedule import Round, Schedule, vector_round


def coset(modulus: int, s: int, t: int) -> list[int]:
    """Coset [t] of the subgroup generated by s in Z_modulus."""
    n = modulus // s
    return [(t + j * s) % modulus for j in range(n)]


def dual_cell(modulus: int, s: int, a: int) -> list[int]:
    """Cell a of the dual partition: {a*s, ..., a*s + s - 1}."""
    return [(a * s + r) % modulus for r in range(s)]


@dataclasses.dataclass(frozen=True)
class DAParams:
    """K = k*s, M = m*s."""

    K: int
    M: int
    s: int

    def __post_init__(self) -> None:
        if self.s < 1 or self.K % self.s or self.M % self.s:
            raise ValueError(f"s={self.s} must divide K={self.K} and M={self.M}")

    @property
    def k(self) -> int:
        return self.K // self.s

    @property
    def m(self) -> int:
        return self.M // self.s

    @property
    def rounds_per_da(self) -> int:
        return self.k * self.m * self.m

    @property
    def num_das(self) -> int:
        return self.s * self.s

    @property
    def total_rounds(self) -> int:  # = K*M^2 / s
        return self.num_das * self.rounds_per_da


def round_vectors(p: DAParams, mu: int, nu: int, a: int, b: int, c: int) -> list[Vector]:
    """The s vectors of round (a, b, c) of DA (μ, ν) — one per column t.

    γ_t = element c of γ-coset [t]        (row γ is never shifted)
    π_t = element a of π-coset [t + μ]    (row π left-shifted μ)
    δ_t = element b of δ-coset [t + ν]    (row δ left-shifted ν)
    """
    out = []
    for t in range(p.s):
        gamma = ((t % p.s) + c * p.s) % p.K
        pi = ((t + mu) % p.s + a * p.s) % p.M
        delta = ((t + nu) % p.s + b * p.s) % p.M
        out.append((gamma, pi, delta))
    return out


def rounds(p: DAParams) -> Iterator[tuple[tuple[int, int, int, int, int], list[Vector]]]:
    """All K*M²/s rounds, keyed (μ, ν, a, b, c) in execution order
    (λ = a + b·m + c·m² fast within a DA, φ = μ + ν·s over DAs)."""
    for nu in range(p.s):
        for mu in range(p.s):
            for c in range(p.k):
                for b in range(p.m):
                    for a in range(p.m):
                        yield (mu, nu, a, b, c), round_vectors(p, mu, nu, a, b, c)


def iter_round_irs(p: DAParams, topo: D3 | None = None):
    """Lazily emit the doubly-parallel rounds as IR ``Round``s — one per DA
    round: every router launches the round's s vectors simultaneously
    (payload = (vector, source id)); the vectors ride in ``meta["vectors"]``
    so the runtime lowering derives one device permutation per vector
    mechanically. Streaming keeps large instances (K·M²·s hop events per
    round) out of memory when callers only need per-round verification."""
    topo = topo or D3(p.K, p.M)
    if (topo.K, topo.M) != (p.K, p.M):
        raise ValueError(f"topology {topo} does not match params {p}")
    routers = list(topo.routers())
    for key, vecs in rounds(p):
        mu, nu, a, b, c = key
        sends = [(r, v) for v in vecs for r in routers]
        tags = [(v, topo.router_id(r)) for v in vecs for r in routers]
        yield vector_round(
            topo,
            sends,
            payloads=tags,
            meta={"key": key, "vectors": tuple(vecs), "da": (mu, nu)},
        )


def schedule(p: DAParams, topo: D3 | None = None) -> Schedule:
    """The full doubly-parallel all-to-all as a unified ``Schedule``:
    K·M²/s rounds — the n/s round count of Theorem 3 with n = K·M² items."""
    topo = topo or D3(p.K, p.M)
    return Schedule(
        "alltoall_doubly_parallel", topo, list(iter_round_irs(p, topo)),
        meta={"params": p, "s": p.s},
    )


def pi_offset_set(p: DAParams, a: int) -> frozenset[int]:
    """Local-link offset classes used by the π phase of a round with
    selector a — dual cell a (independent of μ; see paper §3)."""
    return frozenset(dual_cell(p.M, p.s, a))


def delta_offset_set(p: DAParams, b: int) -> frozenset[int]:
    return frozenset(dual_cell(p.M, p.s, b))


# ---------------------------------------------------------------------------
# Pipelining: measured schedule costs with minimal delay insertion.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PipelineReport:
    offset: int
    num_rounds: int
    delays: int
    total_steps: int  # makespan in router hops (t_w units)

    @property
    def steps_per_round(self) -> float:
        return self.total_steps / self.num_rounds


def round_starts(p: DAParams, offset: int) -> tuple[list[int], int, int]:
    """Launch steps of every round under Schedule-``offset`` pipelining:
    a new round every ``offset`` hops, with a one-hop delay inserted
    whenever a local phase (δ, phase 0, or π, phase 2) of an in-flight
    round would reuse a local-link offset class active in the same step.
    Returns (starts, delays, makespan). Shared by the analytic
    ``pipeline()`` report and the executable ``pipelined_schedule``.
    """
    rounds_ab = [(a, b) for (_, _, a, b, _), _ in rounds(p)]
    start = 0
    delays = 0
    # occupied[step] = set of local-link offset classes in use at that step
    occupied: dict[int, set[frozenset[int]]] = {}
    last_end = 0
    starts: list[int] = []
    for (a, b) in rounds_ab:
        dcell = delta_offset_set(p, b)
        pcell = pi_offset_set(p, a)
        while True:
            ok = (
                dcell not in occupied.get(start, set())
                and pcell not in occupied.get(start + 2, set())
            )
            if ok:
                break
            start += 1
            delays += 1
        occupied.setdefault(start, set()).add(dcell)
        occupied.setdefault(start + 2, set()).add(pcell)
        starts.append(start)
        last_end = max(last_end, start + 3)
        start += offset
    return starts, delays, last_end


def wave_rounds(p: DAParams, offset: int) -> tuple[tuple[int, ...], ...]:
    """Round indices grouped by launch step under Schedule-``offset``
    pipelining: one tuple per distinct ``round_starts`` value, in launch
    order. This is the wave structure the overlapped executors issue —
    ``optimize.exchange_waves`` slices the fused §3 exchange table by these
    launch stamps, and ``overlap_fused`` replay dispatches one wave's
    ppermutes while the previous wave's arrivals are consumed by compute."""
    starts, _, _ = round_starts(p, offset)
    waves: dict[int, list[int]] = {}
    for i, s in enumerate(starts):
        waves.setdefault(s, []).append(i)
    return tuple(tuple(waves[s]) for s in sorted(waves))


def pipeline(p: DAParams, offset: int) -> PipelineReport:
    """Schedule rounds with a new round launched every ``offset`` hops,
    inserting minimal delays (see ``round_starts``).

    Conflict detection uses offset classes: phase 0 of a round uses ALL
    directed local links of the offsets in its δ dual cell; phase 2 uses
    those of its π dual cell; the γ phase uses global links only. Two
    concurrent local phases conflict iff their offset sets intersect
    (dual cells are equal or disjoint). This is exactly the paper's
    Schedule-1 analysis, applied uniformly to every offset.
    """
    starts, delays, last_end = round_starts(p, offset)
    return PipelineReport(offset, len(starts), delays, last_end)


def pipelined_schedule(p: DAParams, offset: int = 1,
                       topo: D3 | None = None) -> Schedule:
    """The §3 all-to-all as an EXECUTABLE pipelined schedule: the same
    rounds as ``schedule()`` with each round's ``meta["start_step"]``
    stamped from the Schedule-``offset`` launch sequence (minimal measured
    delays, ``round_starts``). Lowering propagates the stamps onto every
    stage, so ``start_step``-ordered replay (an overlapping per-stage
    backend) interleaves rounds exactly as the paper's Schedule 1–3 —
    and stays bit-exact, since all-to-all stages read only the immutable
    input."""
    topo = topo or D3(p.K, p.M)
    starts, _, _ = round_starts(p, offset)
    rounds_ir = []
    for rnd, start in zip(iter_round_irs(p, topo), starts):
        meta = dict(rnd.meta)
        meta["start_step"] = start
        rounds_ir.append(Round(rnd.hops, meta))
    return Schedule(
        "alltoall_pipelined", topo, rounds_ir,
        meta={"params": p, "s": p.s, "offset": offset},
    )


def schedule1_predicted_delays(p: DAParams) -> int:
    """Paper's count: a delay per round pair (i, i+2) with a_i == b_{i+2};
    KM total across the whole algorithm."""
    return p.K * p.M


# ---------------------------------------------------------------------------
# Completeness: every vector used exactly once == every (src, dst) pair
# delivered exactly once (vectors biject with destinations per source).
# ---------------------------------------------------------------------------

def all_vectors(p: DAParams) -> list[Vector]:
    return [v for _, vs in rounds(p) for v in vs]


def verify_vector_coverage(p: DAParams) -> None:
    vs = all_vectors(p)
    assert len(vs) == p.K * p.M * p.M, (len(vs), p.K * p.M * p.M)
    if len(set(vs)) != len(vs):
        raise AssertionError("doubly-parallel schedule reuses a vector")
    full = {(g, pi, d) for g in range(p.K) for pi in range(p.M) for d in range(p.M)}
    if set(vs) != full:
        raise AssertionError("doubly-parallel schedule misses vectors")


def alltoall_cost_rounds(p: DAParams, n: int) -> int:
    """Rounds for an all-to-all of n >= K*M² items (paper: n²/(K·M²·s))."""
    P = p.K * p.M * p.M
    if n % P:
        raise ValueError("n must be a multiple of K*M^2")
    x = n // P
    return p.total_rounds * x * x
