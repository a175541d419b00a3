"""Unified Schedule IR — the one conflict-checkable representation that all
four D3 algorithms emit, the simulator verifies, the cost model prices, and
the runtime lowers into backend-neutral collective programs.

A ``Schedule`` is an ordered sequence of ``Round``s. A ``Round`` is a set of
directed ``Hop``s, each stamped with a *step* offset inside the round and a
hashable *payload* tag identifying the packet it carries. Rounds are barriers
by default (round i+1 starts after round i drains); a round may instead carry
``meta["start_step"]`` to describe pipelined schedules where rounds overlap
on the wire — ``core.simulator.verify`` honours it when ``pipelined=True``.

The paper's four algorithms map onto the IR as:

  * matmul (§2)      — KM rounds of 4 phases (steps 0..3), ``startups=2``;
  * all-to-all (§3)  — K·M²/s *vector rounds*: every router launches the
    round's s source vectors simultaneously (steps 0..2 = δ, γ, π phases);
    the vectors ride in ``meta["vectors"]`` so lowering can derive one
    device permutation per vector without re-parsing hop chains;
  * hypercube (§4)   — k+2m rounds, one per cube dimension, hops expanded
    from the dilation-≤3 emulation paths, ``meta["pairs"]`` holding the
    endpoint exchange permutation for the runtime;
  * broadcast (§5)   — spanning-tree rounds of stepped hops (payload = tree
    color), optionally pipelined via ``start_step``.

Everything downstream — ``simulator.verify``, ``costmodel.price``,
``runtime.lowering`` — consumes only this module's types.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Hashable, Iterable, Iterator

from repro_torch.core.topology import D3, Router
from repro_torch.core.routing import Vector, vector_dest


@dataclasses.dataclass(frozen=True)
class Hop:
    """One directed traversal of a physical link at ``step`` of its round."""

    step: int
    src: Router
    dst: Router
    payload: Hashable = 0

    def link(self) -> tuple[Router, Router]:
        return (self.src, self.dst)


@dataclasses.dataclass(frozen=True)
class Round:
    """One barrier-delimited group of hops.

    ``meta`` is free-form per-round metadata. Keys with IR-wide meaning:

      * ``vectors``    — tuple of source vectors (γ,π,δ) for vector rounds,
        used by the runtime to derive ppermute permutations;
      * ``pairs``      — tuple of (src_id, dst_id) endpoint exchanges for
        pairwise-exchange rounds (hypercube dimension rounds);
      * ``startups``   — number of software startups (t_s events) this
        round costs; ``costmodel.price`` defaults it to 1;
      * ``start_step`` — global launch step for pipelined replay.
    """

    hops: tuple[Hop, ...]
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def num_steps(self) -> int:
        return 1 + max((h.step for h in self.hops), default=-1)

    def payloads(self) -> set[Hashable]:
        return {h.payload for h in self.hops}

    def hops_at(self, step: int) -> list[Hop]:
        return [h for h in self.hops if h.step == step]


@dataclasses.dataclass
class Schedule:
    """An ordered list of rounds on a concrete D3 topology."""

    name: str
    topo: D3
    rounds: list[Round]
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def num_rounds(self) -> int:
        return len(self.rounds)

    @property
    def total_steps(self) -> int:
        """Sequential (barrier) makespan in hop steps."""
        return sum(r.num_steps for r in self.rounds)

    @property
    def num_hop_events(self) -> int:
        return sum(len(r.hops) for r in self.rounds)

    def all_hops(self) -> Iterator[tuple[int, Hop]]:
        for i, r in enumerate(self.rounds):
            for h in r.hops:
                yield i, h

    def validate(self) -> None:
        """Every hop must traverse a physical link of the topology."""
        for i, h in self.all_hops():
            if h.src == h.dst:
                raise ValueError(f"round {i}: degenerate hop {h} (elide, don't emit)")
            if not self.topo.is_link(h.src, h.dst):
                raise ValueError(
                    f"round {i}: {h.src} -> {h.dst} is not a link of "
                    f"D3({self.topo.K},{self.topo.M})"
                )


# --------------------------------------------------------------------------
# Builders
# --------------------------------------------------------------------------

def vector_round(
    topo: D3,
    sends: Iterable[tuple[Router, Vector]],
    payloads: Iterable[Hashable] | None = None,
    meta: dict[str, Any] | None = None,
) -> Round:
    """Build a round of simultaneous l-g-l source-vector sends.

    Hop phases are schedule positions, not path positions: the δ hop is
    always step 0, γ step 1, π step 2, and degenerate phases emit no hop —
    this keeps local/global phases aligned across packets, the synchronous
    round model Property 1/3 argue about. Payload defaults to the send's
    index within the round.
    """
    hops: list[Hop] = []
    sends = list(sends)
    tags = list(payloads) if payloads is not None else list(range(len(sends)))
    if len(tags) != len(sends):
        raise ValueError(f"{len(tags)} payloads for {len(sends)} sends")
    for tag, (src, vec) in zip(tags, sends):
        gamma, pi, delta = vec
        r0 = src
        r1 = topo.local_hop(r0, delta)
        r2 = topo.global_hop(r1, gamma)
        r3 = topo.local_hop(r2, pi)
        if r1 != r0:
            hops.append(Hop(0, r0, r1, tag))
        if r2 != r1:
            hops.append(Hop(1, r1, r2, tag))
        if r3 != r2:
            hops.append(Hop(2, r2, r3, tag))
    return Round(tuple(hops), dict(meta or {}))


def hop_round(
    hops: Iterable[tuple[int, Router, Router, Hashable]] | Iterable[Hop],
    meta: dict[str, Any] | None = None,
) -> Round:
    """Build a round from explicit (step, src, dst, payload) hops.
    Degenerate (src == dst) entries are elided — they use no link."""
    out: list[Hop] = []
    for h in hops:
        if not isinstance(h, Hop):
            h = Hop(*h)
        if h.src != h.dst:
            out.append(h)
    return Round(tuple(out), dict(meta or {}))


def path_round(
    paths: Iterable[tuple[list[Router], Hashable]],
    meta: dict[str, Any] | None = None,
    start_step: int = 0,
) -> Round:
    """Build a round from per-packet router paths; hop i of a path lands on
    step ``start_step + i``. Consecutive duplicates (degenerate waits) hold
    their step slot but emit no hop."""
    hops: list[Hop] = []
    for path, tag in paths:
        for i in range(len(path) - 1):
            if path[i] != path[i + 1]:
                hops.append(Hop(start_step + i, path[i], path[i + 1], tag))
    return Round(tuple(hops), dict(meta or {}))


def permutation_of_vector(topo: D3, vec: Vector) -> list[tuple[int, int]]:
    """The device permutation a single source vector induces when every
    router launches it simultaneously: src_id -> id(vector_dest(src, vec)).
    This is a bijection (Property 1) — the mechanical bridge from the IR to
    one ``ppermute`` per vector in the runtime lowering."""
    pairs = []
    for r in topo.routers():
        pairs.append((topo.router_id(r), topo.router_id(vector_dest(topo, r, vec))))
    return pairs
