"""Multi-tenant serving: N models share one mesh through ONE combined host
program.

The port of ``repro.serve.fleet``. Paper Property 2 packs disjoint
D3(J,L) guests onto a D3(K,M) host; ``runtime.combine`` gives the
program-level consequence (N guests' collectives at makespan max(T_i)
instead of ΣT_i). This module serves through it:

* Every tenant model decodes through the staged forward
  (``models.model.decode_step_staged``), which pauses at each MoE boundary
  instead of computing the expert FFN inline.
* ``TenantFleet.step`` drives all tenants' forwards in lockstep: at each
  boundary round it collects every paused tenant's dispatch array
  (``models.moe.moe_guest_dispatch``), scatters them to their guests' host
  slots (``runtime.combine.scatter_guests``) and issues ONE
  ``run_alltoall_compute`` replay of the combined pipelined program
  (``dist.collectives.concurrent_program(..., pipelined=1)``): each chunk
  is processed at its destination device with that tenant's expert shard
  and returned to its sender.
* Admission prefill serves the admitting tenant through the same combined
  program at once (the other guests' slots carry zeros, which guest
  isolation keeps exact), so tenants join mid-traffic.
* Churn is rewrite-only: ``evict`` and ``plan_eviction`` unseat tenants
  through ``train.fault_tolerance.MultiTenantCluster`` (cached
  re-combine), and the next boundary round replays the survivors'
  program. Engines and caches are per tenant, and each survivor's stages
  inside any combined program are its own solo stages, so its in-flight
  requests go on bit for bit across the swap.

``combined=False`` is the time-multiplexed control: the same tenants and
staged decode, but each boundary round replays every tenant's solo
emulated program in turn, ΣT_i rounds.

Backends: ``"reference"``, the port's NumPy replay (the expert FFN in
float32: in NumPy on host copies of the experts where the weights lie on
the host, ``moe.guest_expert_ffn`` on the card's views where they lie
there), and ``"torch_dist"``,
``TorchDistBackend.run_alltoall_compute`` on a process group of
``host_n`` ranks in router order (``group``, the world by default). Every
rank drives the same fleet with the same requests, as the whole-array
``run_*`` contract has it: each rank replays its own host device's row,
computes its arrivals' expert FFN in float32 (``moe.guest_expert_ffn``)
with its tenant's experts as views where the weights lie, and every rank
gets the whole result. The exchanges travel on the group's carrier
(``launch.mesh.carrier_device``: the host under gloo).

All seated tenants share the dispatch chunk signature (E_loc, C, d,
d_ff_expert): one combined replay moves one host-shaped array. Guest
shapes and layer counts may differ. ``collective_report`` needs the
autotuner and raises, naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.emulation import Embedding, embed
from repro_torch.core.topology import D3
from repro_torch.dist.mesh import DeviceLayout
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.serve.engine import Engine, Request
from repro_torch.train.fault_tolerance import MultiTenantCluster


class FleetEngine(Engine):
    """An ``Engine`` whose forward is the staged decode: it pauses at every
    MoE boundary and hands ``(ffn_params, h2)`` to a service callable
    instead of computing the expert FFN inline. Driven two ways: the
    inherited ``_advance`` path (admission prefill, solo stepping) serves
    each boundary at once through ``service``; ``TenantFleet.step`` drives
    ``begin_forward``/``pump`` directly to interleave N tenants'
    boundaries into shared combined replays."""

    def __init__(self, cfg, params, batch_slots: int, max_seq: int, service, device="cuda"):
        super().__init__(cfg, params, batch_slots, max_seq, device=device)
        self._service = service     # (ffn_params, h2) -> y
        self._gen = None
        self._last_logits = None

    def begin_forward(self):
        """Start one staged forward over all slots; returns the first MoE
        boundary's ``(ffn_params, h2)``, or None if the step completed."""
        batch = {"token": torch.from_numpy(self.pending_tok.copy()).to(self.device)}
        positions = torch.from_numpy(self.positions.copy()).to(self.device)
        self._gen = M.decode_step_staged(self.params, self.cache, batch, positions, self.cfg)
        return self.pump(None)

    def pump(self, y):
        """Resume the staged forward with expert output ``y`` (None to
        start). Returns the next boundary's item, or None when the forward
        finished: the logits are then in ``_last_logits`` (host float32)
        and the cache is committed."""
        try:
            item = next(self._gen) if y is None else self._gen.send(y)
        except StopIteration as stop:
            logits, self.cache = stop.value
            self._last_logits = logits.float().cpu().numpy()
            self._gen = None
            return None
        return item

    def _forward(self):
        item = self.begin_forward()
        while item is not None:
            item = self.pump(self._service(*item))
        return self._last_logits


@dataclasses.dataclass
class Tenant:
    """One seated model: its engine, its guest embedding, its traffic."""

    tid: int
    cfg: object
    engine: FleetEngine
    embedding: Embedding
    n_guest: int
    sig: tuple                 # (E_loc, C, d, d_ff_expert) dispatch signature
    queue: list = dataclasses.field(default_factory=list)
    requests: list = dataclasses.field(default_factory=list)


class TenantFleet:
    """N small models as disjoint guests on one D3(K,M) host mesh, every
    tenant's MoE dispatch and combine routed through the single combined
    host program (the module docstring has the whole story).

    ``backend``: ``"reference"`` (the NumPy replay, the expert FFN where
    the weights lie: ``_reference_ffn``) or ``"torch_dist"``
    (``run_alltoall_compute`` over ``group``, which must have ``host_n``
    ranks; every rank drives the same fleet), or a backend object.
    ``combined=False`` switches to the time-multiplexed control.
    ``device`` is where the tenants' engines run: the card unless
    ``"cpu"`` is given; each tenant's parameters must lie there."""

    def __init__(self, host=(2, 2), *, backend="reference", max_seq: int = 64,
                 combined: bool = True, device="cuda", group=None):
        K, M_ = host
        self.cluster = MultiTenantCluster(DeviceLayout(D3(K, M_)))
        self.host = self.cluster.layout.topo
        self.max_seq = max_seq
        self.combined = combined
        self.device = M._device(device)
        self.group = group
        self.backend = self._make_backend(backend)
        self.tenants: dict[int, Tenant] = {}   # insertion order = seat order
        self._next_tid = 0
        self._next_rid = 0
        self._owner = None          # host device -> (tid, guest device) cache
        self.steps_run = 0
        self.replays = 0            # program replays issued at boundaries
        self.rounds_replayed = 0    # Σ num_rounds over those replays
        self._tokens_evicted = 0

    @staticmethod
    def _make_backend(backend):
        if backend == "reference":
            from repro_torch.runtime.backends.reference import NumpyReferenceBackend

            return NumpyReferenceBackend()
        if backend == "torch_dist":
            from repro_torch.runtime.backends.torch_dist import TorchDistBackend

            return TorchDistBackend()
        if isinstance(backend, str):
            raise ValueError(f"unknown fleet backend {backend!r}: 'reference' or 'torch_dist'")
        return backend

    # -------------------------------------------------------------- admission
    def _free_cabinets(self):
        used = set()
        for t in self.tenants.values():
            used |= set(t.embedding.c_set)
        return [c for c in range(self.host.K) if c not in used]

    def _place(self, J: int, L: int) -> Embedding:
        """Cabinet-regime first-fit: each guest takes J whole free cabinets
        (disjoint cabinet sets need no position bookkeeping), so an evicted
        tenant's cabinets free up at once for re-admission."""
        free = self._free_cabinets()
        if L > self.host.M or len(free) < J:
            raise ValueError(
                f"guest D3({J},{L}) does not fit: {len(free)} free cabinets "
                f"of {self.host.K}, host positions {self.host.M}"
            )
        return embed(self.host, J, L, c_set=tuple(free[:J]))

    def admit_model(self, cfg, params, *, guest=(1, 2), slots: int = 2) -> int:
        """Seat a model as a D3(J,L) guest: first-fit placement, cluster
        validation (image disjointness, the program suite derived once) and
        the uniform dispatch-signature check. Returns the tenant id."""
        m = getattr(cfg, "moe", None)
        if m is None:
            raise ValueError(
                "fleet tenants serve their expert dispatch through the "
                "combined program; a config without MoE has no dispatch "
                "to combine — serve it on a plain Engine"
            )
        J, L = guest
        n_guest = J * L * L
        if m.num_experts % n_guest:
            raise ValueError(
                f"E={m.num_experts} experts do not shard over the "
                f"D3({J},{L}) guest's {n_guest} devices"
            )
        sig = (m.num_experts // n_guest, MOE.guest_capacity(m, slots),
               cfg.d_model, m.d_ff_expert)
        for t in self.tenants.values():
            if t.sig != sig:
                raise ValueError(
                    "one combined replay moves one host-shaped array, so "
                    "every tenant must share the dispatch chunk signature "
                    f"(E_loc, C, d, f); seated tenants have {t.sig}, new "
                    f"tenant has {sig}"
                )
        emb = self._place(J, L)
        self.cluster.admit(emb)
        tid = self._next_tid
        self._next_tid += 1
        service = lambda fp, h2, _tid=tid: self._service_single(_tid, fp, h2)
        eng = FleetEngine(cfg, params, slots, self.max_seq, service, device=self.device)
        self.tenants[tid] = Tenant(tid=tid, cfg=cfg, engine=eng,
                                   embedding=emb, n_guest=n_guest, sig=sig)
        self._owner = None
        return tid

    # ---------------------------------------------------------------- traffic
    def submit(self, tid: int, prompt, max_new_tokens: int) -> Request:
        """Enqueue a request for tenant ``tid``; admitted at once if a slot
        is free (its prefill serves its boundaries through the combined
        program right away), queued otherwise."""
        t = self.tenants[tid]
        req = Request(rid=self._next_rid, prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=int(max_new_tokens))
        self._next_rid += 1
        t.requests.append(req)
        if not t.engine.admit(req):
            t.queue.append(req)
        return req

    def step(self):
        """One lockstep decode step for every tenant with active slots: all
        staged forwards advance together, and each MoE boundary round is
        served by ONE combined replay carrying every paused tenant's
        chunks (``combined=False``: one solo replay per tenant instead)."""
        for t in self.tenants.values():
            while t.queue and t.engine.free_slots:
                t.engine.admit(t.queue.pop(0))
        active = {tid: t for tid, t in self.tenants.items() if t.engine.slot_req}
        if not active:
            return
        items = {}
        for tid, t in active.items():
            it = t.engine.begin_forward()
            if it is not None:
                items[tid] = it
        while items:
            ys = self._dispatch(items)
            nxt = {}
            for tid in items:
                it = active[tid].engine.pump(ys[tid])
                if it is not None:
                    nxt[tid] = it
            items = nxt
        for t in active.values():
            t.engine._commit(t.engine._last_logits, decode_slots=list(t.engine.slot_req))
        self.steps_run += 1

    def run_to_completion(self, max_steps: int = 4096):
        for _ in range(max_steps):
            if not any(t.engine.slot_req or t.queue for t in self.tenants.values()):
                break
            self.step()

    @property
    def tokens_out(self) -> int:
        return self._tokens_evicted + sum(t.engine.tokens_out for t in self.tenants.values())

    # ------------------------------------------------------------------ churn
    def evict(self, tid: int):
        """Unseat tenant ``tid`` mid-traffic (its unfinished requests are
        dropped, ``done`` stays False) and re-combine the survivors through
        ``MultiTenantCluster.release``: cached emulate and combine, so
        churn back to a tenant set seen before costs nothing. Returns the
        cluster's ``TenantPlan``."""
        seat = list(self.tenants).index(tid)
        t = self.tenants.pop(tid)
        self._tokens_evicted += t.engine.tokens_out
        self._owner = None
        return self.cluster.release(seat)

    def fail(self, host_device: int) -> None:
        """Mark a host device failed (bookkeeping only; ``plan_eviction``
        acts on it)."""
        self.cluster.fail(host_device)

    def plan_eviction(self):
        """Failure-driven churn: evict exactly the tenants whose guest
        images hold a failed device (``MultiTenantCluster.plan_eviction``)
        and drop them from the fleet; the survivors go on through the
        re-combined program from the next boundary round on."""
        seats = list(self.tenants)
        plan = self.cluster.plan_eviction()
        for pos in plan.evicted:
            t = self.tenants.pop(seats[pos])
            self._tokens_evicted += t.engine.tokens_out
        self._owner = None
        return plan

    # -------------------------------------------------------------- dispatch
    def _embeddings(self) -> tuple[Embedding, ...]:
        return tuple(t.embedding for t in self.tenants.values())

    def program(self):
        """The current tenant set's combined pipelined §3 program (cached
        in ``dist.collectives``, so churn re-combines are lookups)."""
        from repro_torch.dist import collectives as coll

        return coll.concurrent_program("alltoall", self._embeddings(), pipelined=1)

    def _solo_program(self, emb: Embedding):
        from repro_torch.dist import collectives as coll

        return coll.alltoall_program(DeviceLayout(emb.guest), emb, pipelined=1)

    def _host_owner(self) -> dict:
        if self._owner is None:
            self._owner = {}
            for tid, t in self.tenants.items():
                for gdev, hdev in enumerate(t.embedding.device_map):
                    self._owner[int(hdev)] = (tid, gdev)
        return self._owner

    def _service_single(self, tid: int, ffn_params, h2):
        """Serve ONE tenant's boundary (admission prefill, solo stepping),
        still through the fleet's replay, the other guests' slots zero."""
        return self._dispatch({tid: (ffn_params, h2)})[tid]

    def _dispatch(self, items: dict) -> dict:
        """items: {tid: (ffn_params, h2)}, one boundary round. Returns
        {tid: y}, y the (B, S, d) float32 expert output of that tenant."""
        Xs, states = {}, {}
        for tid, (fp, h2) in items.items():
            t = self.tenants[tid]
            Xs[tid], states[tid] = MOE.moe_guest_dispatch(fp, h2, t.cfg, t.n_guest)
        backs = (self._replay_combined(items, Xs) if self.combined
                 else self._replay_muxed(items, Xs))
        return {tid: MOE.moe_guest_combine(backs[tid], states[tid], fp, h2)
                for tid, (fp, h2) in items.items()}

    def _replay_combined(self, items: dict, Xs: dict) -> dict:
        from repro_torch.runtime.combine import extract_guest, scatter_guests

        proto = next(iter(Xs.values()))
        chunk_shape = proto.shape[2:]          # (E_loc, C, d), the same for every tenant
        arrays, guests, order = [], [], []
        for tid, t in self.tenants.items():
            arrays.append(Xs.get(tid, np.zeros((t.n_guest, t.n_guest, *chunk_shape), np.float32)))
            guests.append(t.embedding)
            order.append(tid)
        Xh = scatter_guests(arrays, guests, axes=(0, 1))
        prog = self.program()
        out = self._replay(prog, items, Xh)
        self.replays += 1
        self.rounds_replayed += prog.num_rounds
        return {tid: extract_guest(out, emb, axes=(0, 1))
                for tid, emb in zip(order, guests) if tid in Xs}

    def _replay_muxed(self, items: dict, Xs: dict) -> dict:
        """Time-multiplexed control: each tenant's chunks through its own
        solo emulated program, one after another: the ΣT_i arm."""
        from repro_torch.runtime.combine import extract_guest, scatter_guests

        backs = {}
        for tid in items:
            t = self.tenants[tid]
            prog = self._solo_program(t.embedding)
            Xh = scatter_guests([Xs[tid]], [t.embedding], axes=(0, 1))
            out = self._replay(prog, {tid: items[tid]}, Xh)
            self.replays += 1
            self.rounds_replayed += prog.num_rounds
            backs[tid] = extract_guest(out, t.embedding, axes=(0, 1))
        return backs

    def _replay(self, prog, items: dict, Xh: np.ndarray) -> np.ndarray:
        """One ``run_alltoall_compute`` round trip of ``Xh`` through
        ``prog``, each arriving chunk's expert FFN computed with the owning
        tenant's weights for that destination device."""
        owner = self._host_owner()
        if getattr(self.backend, "name", "") == "reference":
            ffns = {tid: self._reference_ffn(items[tid][0], self.tenants[tid].n_guest)
                    for tid in items}
            # the NumPy replay stacks chunks from every active source at each
            # destination; in a combined program the other guests' slots are
            # structural zeros (no cross-guest links exist), so the FFN runs
            # on the owner guest's source rows only
            act = (np.flatnonzero(prog.active_mask_np) if prog.active_devices is not None
                   else np.arange(prog.n))
            pos = {int(d): k for k, d in enumerate(act)}
            rows = {tid: np.asarray([pos[int(d)] for d in self.tenants[tid].embedding.device_map],
                                    np.intp) for tid in items}

            def compute(j, chunks):
                own = owner.get(int(j))
                if own is None or own[0] not in ffns:
                    return np.zeros_like(chunks)
                g, r = own[1], rows[own[0]]
                out = np.zeros_like(chunks)
                out[r] = ffns[own[0]](g, chunks[r])
                return out

            return self.backend.run_alltoall_compute(Xh, prog, compute)
        return self._replay_dist(prog, items, Xh, owner)

    @staticmethod
    def _reference_ffn(ffn_params, n_guest: int):
        """The ``reference`` replay's expert FFN of one tenant, ``(g,
        chunks) -> out`` on host float32 arrays for guest device ``g``:
        NumPy on host copies of the experts where the weights lie on the
        host; where they lie on the card, ``guest_expert_ffn`` there on
        views of guest device g's experts, cast per call, the chunks moved
        to the card and back."""
        if ffn_params["w_in"].device.type == "cpu":
            wi, wg, wo = MOE.guest_expert_shards(ffn_params, n_guest)
            return lambda g, chunks: MOE.guest_expert_ffn_np(chunks, wi[g], wg[g], wo[g])
        return lambda g, chunks: MOE.guest_expert_ffn(
            torch.from_numpy(chunks), *MOE.guest_experts(ffn_params, n_guest, g)).numpy()

    def _replay_dist(self, prog, items: dict, Xh: np.ndarray, owner: dict) -> np.ndarray:
        """The ``torch_dist`` round trip on this rank: its host device's
        arrivals through its own tenant's experts (views where the weights
        lie, cast to float32 per call), zeros where no seated tenant in
        ``items`` owns the device."""
        import torch.distributed as dist

        from repro_torch.launch.mesh import carrier_device

        own = owner.get(dist.get_rank(self.group))
        if own is None or own[0] not in items:
            def compute(chunks):
                return torch.zeros_like(chunks)
        else:
            tid, g = own
            weights = MOE.guest_experts(items[tid][0], self.tenants[tid].n_guest, g)

            def compute(chunks):
                return MOE.guest_expert_ffn(chunks, *weights)

        carrier = carrier_device(str(dist.get_backend(self.group)), self.device)
        out = self.backend.run_alltoall_compute(torch.from_numpy(Xh).to(carrier), prog, compute,
                                                group=self.group)
        return out.cpu().numpy()

    # ------------------------------------------------------------- reporting
    def collective_report(self, tuner=None) -> dict:
        """The combined-site autotuner decision for this tenant set: it
        needs the autotuner, which is not ported yet."""
        raise NotImplementedError(
            "TenantFleet.collective_report needs the autotuner (runtime/autotune.py), which is "
            "not ported yet: ROADMAP Queue 1 item 3")
