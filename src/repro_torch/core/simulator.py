"""Unified conflict verifier for D3(K, M) schedules.

One entry point proves every theorem in the paper: each algorithm module
(matmul / alltoall / hypercube / broadcast) emits a ``core.schedule.Schedule``
and ``verify(topo, schedule)`` replays it hop-by-hop on the literal graph,
asserting the paper's conflict model:

    within a single hop-step, a DIRECTED link may be used by at most one
    packet (full-duplex links, standard Dragonfly assumption).

The report carries conflicts, round counts, makespan, payload coverage and
per-step link utilization, so tests and benchmarks report *where* a schedule
breaks rather than a bare boolean. Rounds replay as barriers by default;
``pipelined=True`` launches each round at ``meta["start_step"]`` instead, so
the §3/§5 pipelined schedules are measured by the same engine.

The two historical replay modes (``check_vector_round`` for synchronous
vector rounds, the event-driven ``Simulator`` for stepped spanning trees)
are retained as thin wrappers over the same engine.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Hashable

from repro_torch.core.topology import D3, Router
from repro_torch.core.routing import Vector, vector_dest, path_links
from repro_torch.core.schedule import Hop, Round, Schedule, vector_round


@dataclasses.dataclass
class Conflict:
    step: int
    link: tuple[Router, Router]
    packets: list  # payload tags / indices of offending packets
    round_index: int = 0

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"Conflict(round={self.round_index}, step={self.step}, "
            f"link={self.link[0]}->{self.link[1]}, packets={self.packets})"
        )


@dataclasses.dataclass
class VerifyReport:
    """Unified diagnostics for one schedule replay."""

    schedule: str
    num_rounds: int
    total_steps: int  # makespan in hop steps (t_w units)
    conflicts: list[Conflict]
    num_hop_events: int
    reached: dict[Hashable, set[Router]]  # payload -> routers its hops touched
    link_utilization: dict[int, int]  # global step -> links in use

    @property
    def ok(self) -> bool:
        return not self.conflicts

    @property
    def steps_per_round(self) -> float:
        return self.total_steps / max(self.num_rounds, 1)

    def covered(self, payload: Hashable) -> set[Router]:
        return self.reached.get(payload, set())

    def raise_on_conflict(self, context: str = "") -> "VerifyReport":
        assert_conflict_free(self.conflicts, context or self.schedule)
        return self


def _replay_round(
    topo: D3,
    rnd: Round,
    base_step: int,
    round_index: int,
    by_step_link: dict,
    reached: dict,
    util: collections.Counter,
) -> None:
    for h in rnd.hops:
        if not topo.is_link(h.src, h.dst):
            raise ValueError(
                f"not a link in D3({topo.K},{topo.M}): {h.src} -> {h.dst}"
            )
        key = (base_step + h.step, h.src, h.dst)
        by_step_link[key].append((round_index, h.payload))
        reached[h.payload].add(h.dst)
        util[base_step + h.step] += 1


def verify(topo: D3, schedule: Schedule, *, pipelined: bool = False) -> VerifyReport:
    """Replay a Schedule on the literal D3 graph.

    Barrier replay (default): round i+1 starts the step after round i's last
    hop. Pipelined replay: each round starts at ``meta["start_step"]``
    (default 0), so overlapping rounds contend for links — exactly how the
    paper's Schedules 1–3 and the chained broadcast waves are costed.
    """
    by_step_link: dict = collections.defaultdict(list)
    reached: dict = collections.defaultdict(set)
    util: collections.Counter = collections.Counter()
    base = 0
    makespan = 0
    for i, rnd in enumerate(schedule.rounds):
        start = rnd.meta.get("start_step", 0) if pipelined else base
        _replay_round(topo, rnd, start, i, by_step_link, reached, util)
        makespan = max(makespan, start + rnd.num_steps)
        if not pipelined:
            base += rnd.num_steps
    conflicts = []
    for (step, src, dst), users in sorted(by_step_link.items()):
        if len(users) > 1:
            conflicts.append(
                Conflict(step, (src, dst), [p for _, p in users], users[0][0])
            )
    return VerifyReport(
        schedule=schedule.name,
        num_rounds=schedule.num_rounds,
        total_steps=makespan,
        conflicts=conflicts,
        num_hop_events=schedule.num_hop_events,
        reached=dict(reached),
        link_utilization=dict(util),
    )


# ---------------------------------------------------------------------------
# Thin wrappers preserving the historical entry points.
# ---------------------------------------------------------------------------

def check_vector_round(
    topo: D3, sends: list[tuple[Router, Vector]]
) -> tuple[list[Conflict], dict[Router, list[int]]]:
    """Replay one round of simultaneous source-vector sends (the
    Property-1/Property-3 setting). Packet index = position in ``sends``.

    Returns (conflicts, arrivals) where arrivals maps destination router ->
    packet indices that arrived there.
    """
    rnd = vector_round(topo, sends)
    rep = verify(topo, Schedule("vector_round", topo, [rnd]))
    arrivals: dict[Router, list[int]] = collections.defaultdict(list)
    for idx, (src, vec) in enumerate(sends):
        arrivals[vector_dest(topo, src, vec)].append(idx)
    return rep.conflicts, dict(arrivals)


class Simulator:
    """Event-driven directed-hop accumulator replayed by ``verify``."""

    def __init__(self, topo: D3):
        self.topo = topo
        self.hops: list[Hop] = []

    def add_hop(self, step: int, src: Router, dst: Router, packet) -> None:
        if src == dst:
            return  # degenerate, no link used
        if not self.topo.is_link(src, dst):
            raise ValueError(
                f"not a link in D3({self.topo.K},{self.topo.M}): {src} -> {dst}"
            )
        self.hops.append(Hop(step, src, dst, packet))

    def add_path(self, start_step: int, path: list[Router], packet) -> None:
        for i, link in enumerate(path_links(path)):
            self.add_hop(start_step + i, link[0], link[1], packet)

    def as_schedule(self, name: str = "simulator") -> Schedule:
        return Schedule(name, self.topo, [Round(tuple(self.hops))])

    def conflicts(self) -> list[Conflict]:
        return verify(self.topo, self.as_schedule()).conflicts

    @property
    def num_steps(self) -> int:
        return 1 + max((h.step for h in self.hops), default=-1)

    def link_utilization(self) -> dict[int, int]:
        """links used per step — for pipelining/throughput analysis."""
        return verify(self.topo, self.as_schedule()).link_utilization


def assert_conflict_free(conflicts: list[Conflict], context: str = "") -> None:
    if conflicts:
        raise AssertionError(
            f"{context}: {len(conflicts)} link conflicts, first: {conflicts[0]}"
        )
