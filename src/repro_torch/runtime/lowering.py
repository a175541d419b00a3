"""Mechanical lowering: Schedule IR -> backend-neutral ``CollectiveProgram``.

One entry point, ``lower(schedule)``, dispatches on per-round metadata
instead of per-algorithm functions — all four of the paper's algorithms
arrive here as the same IR and leave as the same program type:

  * *vector rounds* (``meta["vectors"]``) — one full device ``Perm`` per
    source vector (Property 1 makes every vector a bijection of the router
    set): the §3 doubly-parallel all-to-all;
  * *exchange rounds* (``meta["pairs"]``) — one full-permutation
    ``ReduceCombine`` per round, the endpoint involution of the §4
    hypercube dimension exchanges (combine = sum for all-reduce);
  * *matmul rounds* (``meta["matmul"]``) — the §2 4-phase round becomes
    ``LocalContract('load_b')``, the juxtaposition ``Match`` matchings, a
    ``LocalContract('mul_a')`` block product, the mirrored-accumulation
    ``ReduceCombine`` matchings (identity pairs = local adds), accumulator
    promotions, the Z-fix ``Match`` and a masked ``LocalContract('store_c')``;
  * *tree rounds* (stepped spanning-tree hops, anything else) — per-step
    maximal matchings (``Match``), the §5 broadcasts.

Device index = ``topo.router_id`` (the linear c·M²+d·M+p order), so a 1-D
mesh axis of K·M² devices is the D3 network and the conflict-freedom the
simulator proved for the IR is exactly the claim that each lowered step's
stages can fly concurrently on the physical links.

Every stage is stamped with the IR ``(round_index, step)`` it came from and
a ``start_step``: the round's ``meta["start_step"]`` launch offset when
present (pipelined schedules), else the barrier-replay base — so a stable
sort by ``start_step`` IS the pipelined replay and barrier programs are
unchanged by it.

Lowering is pure Python on hashable IR — no torch imports — so it can be
cached per (topology, schedule) and reused across traces.
"""

from __future__ import annotations

from repro_torch.core.schedule import Round, Schedule, permutation_of_vector
from repro_torch.core.topology import D3
from repro_torch.runtime.program import (
    CollectiveProgram,
    LocalContract,
    Match,
    Perm,
    ReduceCombine,
    Stage,
)


def lower(schedule: Schedule, *, optimized: bool = False):
    """Lower any Schedule to a ``CollectiveProgram`` by round metadata.

    ``optimized=True`` additionally runs the fusion pass and returns the
    ``runtime.optimize.OptimizedProgram`` (batched table ops; replayable by
    every backend) — the one-call path from IR to the fast replay form.
    """
    if not schedule.rounds:
        raise ValueError(f"empty schedule {schedule.name!r}")
    family = _round_family(schedule.rounds[0])
    for rnd in schedule.rounds[1:]:
        if _round_family(rnd) != family:
            raise ValueError(
                f"schedule {schedule.name!r} mixes round families; "
                f"got {family} then {_round_family(rnd)}"
            )
    program = _LOWERERS[family](schedule)
    if optimized:
        from repro_torch.runtime.optimize import optimize

        return optimize(program)
    return program


def _round_family(rnd: Round) -> str:
    if "vectors" in rnd.meta:
        return "vector"
    if "pairs" in rnd.meta:
        return "exchange"
    if "matmul" in rnd.meta:
        return "matmul"
    return "tree"


def _round_start(rnd: Round, barrier_base: int) -> int:
    """Launch step of a round: its pipelined offset if stamped, else the
    barrier base — so ``start_step`` ordering replays pipelined schedules
    and leaves barrier schedules untouched."""
    start = rnd.meta.get("start_step")
    return barrier_base if start is None else start


# --------------------------------------------------------------- all-to-all
def _lower_vector(schedule: Schedule) -> CollectiveProgram:
    """Each round's s vectors -> s device permutations (one ppermute each).
    K·M²/s rounds × s vectors = K·M² permutes for the full exchange."""
    topo = schedule.topo
    stages: list[Stage] = []
    base = 0
    for i, rnd in enumerate(schedule.rounds):
        start = _round_start(rnd, base)
        for v in rnd.meta["vectors"]:
            stages.append(
                Perm(tuple(permutation_of_vector(topo, v)),
                     round_index=i, step=0, start_step=start)
            )
        base += rnd.num_steps
    return CollectiveProgram(
        "alltoall", topo.num_routers, schedule.num_rounds, tuple(stages),
        name=schedule.name,
    )


# ---------------------------------------------------------------- exchange
def _lower_exchange(schedule: Schedule) -> CollectiveProgram:
    """One full-permutation combine per round from meta['pairs'] (hypercube
    dimension exchanges: involutions over the node set)."""
    n = schedule.topo.num_routers
    stages: list[Stage] = []
    base = 0
    for i, rnd in enumerate(schedule.rounds):
        stages.append(
            ReduceCombine(n, tuple(rnd.meta["pairs"]),
                          round_index=i, step=0,
                          start_step=_round_start(rnd, base))
        )
        base += rnd.num_steps
    return CollectiveProgram(
        "allreduce", n, schedule.num_rounds, tuple(stages), name=schedule.name,
    )


# --------------------------------------------------------------- broadcast
def hops_to_matchings(topo: D3, rnd: Round) -> list[tuple[int, tuple]]:
    """Decompose a tree round's hops, step by step, into (step, pairs)
    matchings. Within a step a source may fan out to several children
    (packet duplication); each fan-out degree becomes one matching. Step
    order is preserved so data dependencies (parent before child) hold."""
    out: list[tuple[int, tuple]] = []
    for step in range(rnd.num_steps):
        remaining = [(topo.router_id(h.src), topo.router_id(h.dst)) for h in rnd.hops_at(step)]
        while remaining:
            used_src: set[int] = set()
            used_dst: set[int] = set()
            matching: list[tuple[int, int]] = []
            rest: list[tuple[int, int]] = []
            for s, d in remaining:
                if s not in used_src and d not in used_dst:
                    used_src.add(s)
                    used_dst.add(d)
                    matching.append((s, d))
                else:
                    rest.append((s, d))
            out.append((step, tuple(matching)))
            remaining = rest
    return out


def _broadcast_root(schedule: Schedule) -> int:
    """Resolve the root device id. Explicit ``is None`` checks: router id 0
    and router (0, 0, 0) are legitimate falsy-looking roots."""
    root = schedule.meta.get("root")
    if root is None:
        root = schedule.meta.get("source")
    if root is None:
        raise ValueError(
            f"broadcast schedule {schedule.name!r} lacks meta['root']/['source']"
        )
    if isinstance(root, int):
        return root
    return schedule.topo.router_id(root)


def _lower_tree(schedule: Schedule) -> CollectiveProgram:
    """Spanning-tree rounds -> ordered masked matchings. Multi-round
    schedules are pipelined broadcast waves: round w's stages act on wave
    slice w and carry its ``start_step`` launch offset."""
    topo = schedule.topo
    n = topo.num_routers
    stages: list[Stage] = []
    base = 0
    for i, rnd in enumerate(schedule.rounds):
        start = _round_start(rnd, base)
        for step, pairs in hops_to_matchings(topo, rnd):
            stages.append(Match(n, pairs, round_index=i, step=step,
                                start_step=start + step))
        base += rnd.num_steps
    return CollectiveProgram(
        "broadcast", n, schedule.num_rounds, tuple(stages),
        root=_broadcast_root(schedule), name=schedule.name,
    )


# ------------------------------------------------------------------ matmul
def _lower_matmul(schedule: Schedule) -> CollectiveProgram:
    """§2 rounds -> the program the paper's Theorem 1 executes per row:

        load_b; K+M-1 bcast matchings; mul_a; K+M reduce-combines;
        promote; zfix match; store_c(mask)

    with a ``promote`` between the global and nothing else — the two
    accumulator promotions realize the paper's two off-and-ons."""
    topo = schedule.topo
    n = topo.num_routers
    grid = None
    stages: list[Stage] = []
    base = 0
    for i, rnd in enumerate(schedule.rounds):
        mm = rnd.meta["matmul"]
        grid = rnd.meta.get("grid", grid)
        start = _round_start(rnd, base)
        stages.append(LocalContract("load_b", round_index=i, step=0,
                                    start_step=start))
        for step, pairs in mm["bcast"]:
            stages.append(Match(n, pairs, round_index=i, step=step,
                                start_step=start + step))
        stages.append(LocalContract("mul_a", round_index=i, step=2,
                                    start_step=start + 2))
        glob = [sp for sp in mm["reduce"] if sp[0] == 2]
        loc = [sp for sp in mm["reduce"] if sp[0] != 2]
        for step, pairs in glob:
            stages.append(ReduceCombine(n, pairs, round_index=i, step=step,
                                        start_step=start + step))
        stages.append(LocalContract("promote", round_index=i, step=3,
                                    start_step=start + 3))
        for step, pairs in loc:
            stages.append(ReduceCombine(n, pairs, round_index=i, step=step,
                                        start_step=start + step))
        stages.append(LocalContract("promote", round_index=i, step=4,
                                    start_step=start + 4))
        zstep, zpairs = mm["zfix"]
        if zpairs:
            stages.append(Match(n, zpairs, round_index=i, step=zstep,
                                start_step=start + zstep))
        stages.append(LocalContract("store_c", mask=mm["store_mask"], n=n,
                                    round_index=i, step=zstep + 1,
                                    start_step=start + zstep + 1))
        base += rnd.num_steps + 1  # + the zfix storage hop
    return CollectiveProgram(
        "matmul", n, schedule.num_rounds, tuple(stages), grid=grid,
        name=schedule.name,
    )


_LOWERERS = {
    "vector": _lower_vector,
    "exchange": _lower_exchange,
    "tree": _lower_tree,
    "matmul": _lower_matmul,
}


# ---------------------------------------------------------------------------
# Named entry points retained as thin wrappers over ``lower`` — they assert
# the caller got the program family it expected.
# ---------------------------------------------------------------------------

def _expect(schedule: Schedule, kind: str) -> CollectiveProgram:
    prog = lower(schedule)
    if prog.kind != kind:
        raise ValueError(
            f"schedule {schedule.name!r} lowered to {prog.kind!r}, expected {kind!r}"
        )
    return prog


def lower_alltoall(schedule: Schedule) -> CollectiveProgram:
    return _expect(schedule, "alltoall")


def lower_exchange(schedule: Schedule) -> CollectiveProgram:
    return _expect(schedule, "allreduce")


def lower_broadcast(schedule: Schedule) -> CollectiveProgram:
    return _expect(schedule, "broadcast")


def lower_matmul(schedule: Schedule) -> CollectiveProgram:
    return _expect(schedule, "matmul")
