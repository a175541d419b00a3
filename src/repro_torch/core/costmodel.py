"""Analytic network-cost models — the paper's comparison tables.

The port of ``repro.core.costmodel``, pure Python. One change: ``seconds``
takes the link ``bandwidth`` as a keyword with no default (the JAX
package's default is a TPU link's), so every caller names its own link.

All costs in units of t_w (router latency) unless noted. P = number of
processors/routers. These formulas back benchmarks/ tables 1:1 with §2-§5.

``price(schedule, t_w, t_s)`` prices a concrete ``core.schedule.Schedule``
so analytic tables and replayed schedules are cross-checked from the SAME
object: e.g. ``price(alltoall.schedule(p))`` must equal
``alltoall_schedule3(K, M, s)`` with t_s = 0, and ``price(matmul.schedule(g),
t_w, t_s)`` must equal ``matmul.network_time(g, g.n, t_w, t_s)``.
"""

from __future__ import annotations

import math


def price(schedule, t_w: float = 1.0, t_s: float = 0.0) -> float:
    """Barrier-replay cost of a Schedule: each round pays its step count in
    t_w plus ``meta["startups"]`` (default 1) software startups in t_s."""
    total = 0.0
    for r in schedule.rounds:
        total += r.num_steps * t_w + r.meta.get("startups", 1) * t_s
    return total


def price_pipelined(schedule, t_w: float = 1.0, t_s: float = 1.0) -> float:
    """Pipelined makespan: rounds launch at meta["start_step"] and overlap;
    one startup for the whole pipeline."""
    end = 0
    for r in schedule.rounds:
        end = max(end, r.meta.get("start_step", 0) + r.num_steps)
    return end * t_w + t_s


# ------------------------------- §2 table: n×n matmul network costs -------
def matmul_d3(n: float, P: float) -> float:
    """D3(K²,M): 4 t_w n²/√P (P = K²M² routers, √P = KM)."""
    return 4.0 * n * n / math.sqrt(P)


def matmul_cannon(n: float, P: float) -> float:
    return 2.0 * n * n / math.sqrt(P)


def matmul_hje(n: float, P: float) -> float:
    return 2.0 * n * n / math.sqrt(P) * math.log2(P)


def matmul_dns_sqrt(n: float, P: float) -> float:
    return 2.0 * n * n / math.sqrt(P)


def matmul_gs(n: float, P: float) -> float:
    return 3.0 * n * n / P ** (2.0 / 3.0) * math.log2(P)


def matmul_dns_23(n: float, P: float) -> float:
    return 4.0 * n * n / P ** (2.0 / 3.0)


MATMUL_TABLE = {
    "D3(K^2,M)": matmul_d3,
    "Cannon": matmul_cannon,
    "HJE": matmul_hje,
    "DNS": matmul_dns_sqrt,
    "GS": matmul_gs,
    "DNS-P^2/3": matmul_dns_23,
}


# ------------------------------- §3 all-to-all -----------------------------
def alltoall_doubly_parallel(K: int, M: int, s: int, n: int | None = None) -> float:
    """KM²/s rounds; n ≥ KM² items -> n²/(KM²s)."""
    P = K * M * M
    if n is None:
        n = P
    return n * n / (P * s)


def alltoall_schedule1(K: int, M: int, s: int) -> float:
    return (K * M * M / s + K * M) / s


def alltoall_schedule2(K: int, M: int, s: int) -> float:
    return 2.0 * K * M * M / s


def alltoall_schedule3(K: int, M: int, s: int) -> float:
    return 3.0 * K * M * M / s


def alltoall_johnsson_ho(P: int, n: int | None = None) -> float:
    """Boolean hypercube: t_w·P/2; size n ≥ P -> n²/2P."""
    if n is None:
        n = P
    return n * n / (2.0 * P)


def alltoall_jh_on_sbh(k: int, m: int) -> float:
    """§4: Johnsson-Ho run through the SBH emulation: (2/3)... the paper
    uses avg dilation 2 => 2 · (2^{k+2m}/2) = 2^{k+2m}; it quotes
    (2/3)·(2^{k+2m}/2)·3 — we report dilation·P/2 with avg dilation 2."""
    P = 1 << (k + 2 * m)
    return 2.0 * P / 2.0


def alltoall_dp_on_d3_2k2m(k: int, m: int) -> float:
    """§4: s = min(2^k, 2^{m-1}) -> max(2^m, 2^{k+m+1})."""
    return float(max(1 << m, 1 << (k + m + 1)))


# ------------------------------- §5 broadcast ------------------------------
def broadcast_depth3(X: int) -> float:
    """Pipelined depth-3 tree: X hops for X broadcasts (+2 drain)."""
    return float(X)


def broadcast_m_tree(X: int, M: int) -> float:
    """Pair-chained M depth-4 trees: 3X/M."""
    return 3.0 * X / M


# ------------------------------- hardware-time helpers ---------------------
def seconds(
    hops: float,
    t_w: float = 1.0e-6,
    t_s: float = 0.0,
    *,
    bytes_per_hop: float = 0.0,
    bandwidth: float,
) -> float:
    """Wall-clock estimate of ``hops`` network steps.

    The paper prices in t_w units (one router hop per step); real links
    also pay serialization time proportional to the message size, and the
    crossover between strategies moves with it — so the autotuner needs
    prices that SCALE with bytes. Each hop costs ``t_w`` (router latency)
    plus ``bytes_per_hop / bandwidth`` (wire time at the caller's link
    rate, in bytes/s), and the call pays ``t_s`` software startup once:

        seconds = hops · (t_w + bytes_per_hop / bandwidth) + t_s

    ``bytes_per_hop=0`` reproduces the original latency-only form.
    """
    per_hop = t_w + (bytes_per_hop / bandwidth if bytes_per_hop else 0.0)
    return hops * per_hop + t_s
