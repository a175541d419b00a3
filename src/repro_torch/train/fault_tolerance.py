"""Fault tolerance & elasticity.

The port of ``repro.train.fault_tolerance``: host code, line for line, on
the port's own ``core``, ``runtime.rewrite``, ``runtime.combine`` and
``dist.mesh``.

* Failure handling: on detected chip/host loss, remap to the largest
  embeddable D3(J, L) subnetwork (paper Property 2 — core/emulation.py)
  and REWRITE the already-lowered guest programs onto the survivors
  (``runtime.rewrite.emulate``). Recovery never calls back into the
  ``core.{matmul,alltoall,broadcast,hypercube}`` derivations: schedules
  are derived + lowered ONCE, ahead of failures, into a per-shape program
  library (``prepare_fallbacks``), and ``plan_recovery`` is a pure lookup
  + relabel — cheap enough to run inside the failover window, and cached
  (``emulate`` memoizes per (program, embedding)) so repeated failovers
  onto the same survivor set are free.
* Multi-tenant failure handling: ``MultiTenantCluster`` runs N disjoint
  guests on one host via the ``runtime.combine`` combinator. When chips
  die, only the tenants whose images were hit are EVICTED; the survivors'
  already-rewritten programs are RE-COMBINED (``plan_eviction``) — lookup
  + relabel + merge, every step memoized, zero re-derivation and zero
  re-lowering — so the unaffected tenants keep their schedules, stamps
  and bits while the failed tenant drains.
* Straggler mitigation: deadline-based microbatch accounting — rounds are
  deterministic (the paper's conflict-free schedules have no stochastic
  congestion), so a late participant is detected by round index; the
  runner drops the straggler's microbatch and renormalizes the gradient.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.emulation import Embedding, embed, largest_embeddable
from repro_torch.core.schedule import Schedule
from repro_torch.core.topology import D3
from repro_torch.dist.mesh import DeviceLayout
from repro_torch.runtime.program import CollectiveProgram
from repro_torch.runtime.rewrite import emulate, emulate_schedule


class UnpreparedShapeError(LookupError):
    """plan_recovery needed a guest shape the library doesn't hold.

    Recovery is rewrite-only by design — it will not fall back to deriving
    schedules. Call ``ClusterState.prepare_fallbacks()`` (or
    ``prepare_shape(J, L)``) ahead of failures.
    """


@dataclasses.dataclass(frozen=True)
class LoweredSuite:
    """The derive-once artifacts for one guest shape: the Schedule IRs (for
    host-graph verification via ``emulate_schedule``) and their lowered
    ``CollectiveProgram``s (for execution via ``emulate``). ``root`` is the
    guest broadcast root the suite was derived with — the shape library
    refuses to serve a cached suite under a different root."""

    schedules: dict[str, Schedule]
    programs: dict[str, CollectiveProgram]
    root: int = 0


@dataclasses.dataclass(frozen=True)
class RecoveryPlan:
    """Everything failover needs, produced WITHOUT re-deriving schedules.

    ``programs`` are host-sized rewrites of the guest suite (replayable on
    the surviving mesh as-is, ``active_devices`` = survivor ids in guest
    order); ``schedules`` are the matching host-graph Schedule views for
    ``core.simulator.verify``; ``index_map`` maps guest device id → host
    device id (= ``embedding.device_map``).
    """

    layout: DeviceLayout           # the guest D3(J, L) view
    embedding: Embedding
    index_map: dict[int, int]
    programs: dict[str, CollectiveProgram]
    schedules: dict[str, Schedule]


#: monotone count of derive+lower suite builds — the hook behind the
#: rewrite-only assertion: an elastic trainer snapshots it around every
#: failover and asserts the delta is zero (recovery must be pure lookup
#: + relabel, never a call back into the core schedule derivations).
_derivations = 0


def derivation_count() -> int:
    """How many times ``lower_layout_programs`` has run in this process."""
    return _derivations


def lower_layout_programs(layout: DeviceLayout, *, root: int = 0) -> LoweredSuite:
    """Derive + lower the paper's algorithm suite for one layout.

    This is the ONLY recovery-adjacent function that calls into the core
    algorithm modules — it runs at preparation time (cluster bring-up),
    never inside ``plan_recovery``. Kinds a shape cannot support are
    skipped: no SBH all-reduce off powers of two, no §2 grid when K is not
    a perfect square, and degenerate shapes (single drawer/cabinet) skip
    whichever derivations reject them.
    """
    global _derivations
    _derivations += 1
    from repro_torch.core import alltoall as a2a
    from repro_torch.core import broadcast as bc
    from repro_torch.core import hypercube as hc
    from repro_torch.core import matmul as mm
    from repro_torch.runtime import lowering

    topo = layout.topo
    schedules: dict[str, Schedule] = {}
    try:
        schedules["alltoall"] = a2a.schedule(layout.da_params, topo)
    except (ValueError, AssertionError):
        pass
    if layout.sbh is not None and layout.sbh.dims > 0:
        # dims == 0 is the degenerate single-router D3(1,1) guest: its
        # "hypercube" has no dimensions and would lower to an empty program
        schedules["allreduce"] = hc.allreduce_schedule(layout.sbh)
    try:
        schedules["broadcast"] = bc.depth3_schedule(topo, topo.id_router(root))
    except (ValueError, AssertionError):
        pass
    k = int(round(topo.K ** 0.5))
    if k * k == topo.K:
        schedules["matmul"] = mm.schedule(mm.MatmulGrid(k, topo.M))
    programs = {kind: lowering.lower(s) for kind, s in schedules.items()}
    return LoweredSuite(schedules=schedules, programs=programs, root=root)


@dataclasses.dataclass
class _HostState:
    """Shared failure bookkeeping + derive-once program library: the host
    layout, the dead-router set, and the guest-shape suite cache that both
    the single-workload ``ClusterState`` and the multi-tenant cluster
    maintain identically."""

    layout: DeviceLayout
    dead: set = dataclasses.field(default_factory=set)
    #: guest shape (J, L) -> derive-once suite; filled by prepare_shape.
    library: dict = dataclasses.field(default_factory=dict)

    def fail(self, device_index: int) -> None:
        self.dead.add(self.layout.topo.id_router(device_index))

    def prepare_shape(self, J: int, L: int, *, root: int = 0) -> LoweredSuite:
        """Derive + lower the suite for guest D3(J, L) (idempotent) — the
        only recovery-adjacent call into the core derivations. A cache hit
        under a DIFFERENT broadcast root is refused rather than silently
        serving the wrong root's programs."""
        key = (J, L)
        suite = self.library.get(key)
        if suite is None:
            suite = self.library[key] = lower_layout_programs(
                DeviceLayout(D3(J, L)), root=root)
        elif suite.root != root:
            raise ValueError(
                f"suite for D3({J},{L}) was prepared with broadcast root "
                f"{suite.root}; re-preparing with root {root} would serve "
                "mixed roots — use a separate library"
            )
        return suite


@dataclasses.dataclass
class ClusterState(_HostState):
    def fallback_shapes(self) -> list[tuple[int, int]]:
        """Every shape ``largest_embeddable`` can return on this pod —
        the full mixed ladder. The pure regimes reach only the cabinet-
        drop column (j, M) and the position-drop row (K, l); the mixed
        cabinet×position search can land on ANY (j, l) with 1 ≤ j ≤ K,
        1 ≤ l ≤ M (e.g. striped failures dropping one cabinet and one
        position), so the library pre-lowers the whole grid, largest
        survivors first (ties toward whole drawers, mirroring the
        search's own tie-break), the healthy (K, M) included."""
        K, M = self.layout.topo.K, self.layout.topo.M
        return sorted(
            ((j, l) for j in range(1, K + 1) for l in range(1, M + 1)),
            key=lambda jl: (-(jl[0] * jl[1] * jl[1]), -jl[1], -jl[0]),
        )

    def prepare_fallbacks(self, shapes=None, *, root: int = 0) -> None:
        """Populate the program library ahead of failures — the derive/lower
        cost is paid here, once, so the failover window never pays it."""
        for J, L in (shapes if shapes is not None else self.fallback_shapes()):
            self.prepare_shape(J, L, root=root)

    # --------------------------------------------------------- failure time
    def plan_recovery(self) -> RecoveryPlan:
        """Rewrite-only failover: largest embeddable survivor network, then
        relabel the prepared guest suite through the embedding. Zero calls
        into core schedule derivations and zero re-lowering — raises
        ``UnpreparedShapeError`` if the shape was never prepared."""
        J, L, c_set, p_set = largest_embeddable(self.layout.topo, self.dead)
        emb = embed(self.layout.topo, J, L, c_set=c_set, p_set=p_set)
        suite = self.library.get((J, L))
        if suite is None:
            raise UnpreparedShapeError(
                f"no prepared programs for guest D3({J},{L}); call "
                f"prepare_fallbacks() (or prepare_shape({J}, {L})) before "
                "failures — recovery does not re-derive schedules"
            )
        programs = {kind: emulate(prog, emb) for kind, prog in suite.programs.items()}
        schedules = {kind: emulate_schedule(s, emb) for kind, s in suite.schedules.items()}
        index_map = {g: int(h) for g, h in enumerate(emb.device_map)}
        return RecoveryPlan(
            layout=DeviceLayout(emb.guest),
            embedding=emb,
            index_map=index_map,
            programs=programs,
            schedules=schedules,
        )


# ---------------------------------------------------------------------------
# Concurrent guests: N tenants on one host, eviction by re-combination.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TenantPlan:
    """One eviction step's output: who stays, who goes, and the combined
    programs the survivors keep running — produced WITHOUT re-deriving or
    re-lowering anything (``emulate`` and ``combine`` are both memoized,
    so repeat failovers onto the same tenant set are cache hits)."""

    surviving: tuple[int, ...]            # tenant ids kept, admission order
    evicted: tuple[int, ...]
    embeddings: tuple[Embedding, ...]     # survivors' (unchanged) embeddings
    programs: dict[str, CollectiveProgram]  # combined, over the survivors
    index_maps: tuple[dict[int, int], ...]  # per survivor: guest id -> host id


@dataclasses.dataclass
class MultiTenantCluster(_HostState):
    """N disjoint D3(J,L) guests time-sharing NOTHING: their rewritten
    programs interleave on one host mesh (``runtime.combine``).

    ``admit`` validates image-disjointness against the sitting tenants and
    derives + lowers the guest's suite ONCE (the only time core
    derivations run); ``fail`` marks host chips dead; ``plan_eviction``
    evicts exactly the tenants whose images were hit and re-combines the
    survivors' programs — the other guests keep running with their
    schedules, stamps and bits unchanged. Failure bookkeeping and the
    shape library are the inherited ``_HostState``.
    """

    tenants: list = dataclasses.field(default_factory=list)  # Embeddings

    # ------------------------------------------------------ admission time
    def admit(self, embedding: Embedding) -> int:
        """Seat a tenant: reject image overlaps, prepare its program suite
        (derive + lower, idempotent per shape). Returns the tenant id."""
        if embedding.host != self.layout.topo:
            raise ValueError(
                f"tenant embeds into D3({embedding.host.K},{embedding.host.M})"
                f", host is D3({self.layout.topo.K},{self.layout.topo.M})"
            )
        image = set(int(h) for h in embedding.device_map)
        dead_ids = {self.layout.topo.router_id(r) for r in self.dead}
        if image & dead_ids:
            raise ValueError(
                f"tenant image includes failed host devices "
                f"{sorted(image & dead_ids)[:4]}"
            )
        for tid, sitting in enumerate(self.tenants):
            clash = image & {int(h) for h in sitting.device_map}
            if clash:
                raise ValueError(
                    f"tenant overlaps tenant {tid} on host devices "
                    f"{sorted(clash)[:4]}"
                )
        self.prepare_shape(embedding.guest.K, embedding.guest.M)
        self.tenants.append(embedding)
        return len(self.tenants) - 1

    # --------------------------------------------------------- failure time
    def plan_eviction(self, kinds=None) -> TenantPlan:
        """Evict the tenants whose images contain a dead chip; re-combine
        the survivors (rewrite-only: cached ``emulate`` + cached
        ``combine``, no derivations, no lowering). ``kinds`` defaults to
        every kind all survivors' suites support.

        Evicted tenants are UNSEATED: their embeddings leave
        ``self.tenants``, so a replacement tenant can later ``admit`` onto
        the freed healthy routers. The returned plan reports survivor and
        evictee ids as positions at call time.
        """
        dead_ids = {self.layout.topo.router_id(r) for r in self.dead}
        surviving, evicted = [], []
        for tid, emb in enumerate(self.tenants):
            hit = dead_ids & {int(h) for h in emb.device_map}
            (evicted if hit else surviving).append(tid)
        if not surviving:
            raise RuntimeError("no tenant survives the failure set")
        return self._recombine(surviving, evicted, kinds)

    def release(self, tenant_index: int, kinds=None) -> TenantPlan:
        """Voluntary churn: unseat tenant ``tenant_index`` (a position in
        admission order at call time, no failure involved) and re-combine
        the remaining tenants — the same cached-rewrite path as
        ``plan_eviction``, so releasing back to a previously-seen tenant
        set costs a cache lookup. Unlike failure-driven eviction, releasing
        the LAST tenant is legal: the plan simply carries no survivors and
        an empty program dict."""
        if not 0 <= tenant_index < len(self.tenants):
            raise IndexError(
                f"tenant index {tenant_index} out of range "
                f"({len(self.tenants)} seated)"
            )
        surviving = [t for t in range(len(self.tenants)) if t != tenant_index]
        return self._recombine(surviving, [tenant_index], kinds)

    def _recombine(self, surviving, evicted, kinds) -> TenantPlan:
        """Unseat ``evicted`` and combine the survivors' programs — the
        shared rewrite-only tail of ``plan_eviction`` and ``release``
        (cached ``emulate`` + cached ``combine``, zero derivations)."""
        from repro_torch.runtime.combine import GuestConflictError, combine

        embs = tuple(self.tenants[t] for t in surviving)
        self.tenants = list(embs)  # unseat the evicted tenants
        programs: dict[str, CollectiveProgram] = {}
        if embs:
            suites = [self.library[(e.guest.K, e.guest.M)] for e in embs]
            supported = set(suites[0].programs)
            for s in suites[1:]:
                supported &= set(s.programs)
            # explicit kinds intersect with what every survivor supports,
            # the same skip-unsupported semantics as lower_layout_programs
            kinds = supported if kinds is None else set(kinds) & supported
            for kind in sorted(kinds):
                try:
                    programs[kind] = combine(
                        [emulate(s.programs[kind], e)
                         for s, e in zip(suites, embs)]
                    )
                except GuestConflictError:
                    if kind == "matmul":  # shape-mixed tenants can't share
                        continue          # the local-contract skeleton
                    raise
        return TenantPlan(
            surviving=tuple(surviving),
            evicted=tuple(evicted),
            embeddings=embs,
            programs=programs,
            index_maps=tuple(
                {g: int(h) for g, h in enumerate(e.device_map)} for e in embs
            ),
        )


@dataclasses.dataclass
class StragglerPolicy:
    deadline_factor: float = 3.0   # × median step time
    min_participants: float = 0.75  # refuse to proceed below this fraction

    def judge(self, durations_s: list[float]) -> list[bool]:
        """True = keep, False = drop (straggler)."""
        if not durations_s:
            return []
        med = sorted(durations_s)[len(durations_s) // 2]
        keep = [d <= self.deadline_factor * max(med, 1e-9) for d in durations_s]
        if sum(keep) < self.min_participants * len(keep):
            # too many stragglers: likely a systemic stall — keep everyone
            return [True] * len(keep)
        return keep


def renormalized_scale(kept: int, total: int) -> float:
    """Gradient renormalization when microbatches are dropped."""
    return total / max(kept, 1)
