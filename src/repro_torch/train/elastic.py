"""Always-on elastic training: survive chip failures mid-run without a
process restart.

The paper gives both halves of the mechanism. Property 2 (§1/§6) makes the
pod elastic: D3(K, M) contains a dilation-1 copy of every D3(J, L), so when
chips die the run shrinks to the largest embeddable survivor network and
every prepared schedule transfers verbatim through ``plan_recovery``'s
rewrite (no re-derivation — asserted via ``derivation_count``). The §5
depth-3 broadcast is the redistribution primitive: the latest checkpointed
parameters are replayed through the REWRITTEN broadcast program, so the
payload travels the exact conflict-free routes the survivor network will
keep using for training collectives, landing on every device of
``RecoveryPlan.index_map``.

Failover sequence (``ElasticTrainer._failover``):

1. mark the injected/detected devices dead on the ``ClusterState``;
2. ``plan_recovery()`` — pure library lookup + relabel (zero calls into
   the core schedule derivations; the delta of ``derivation_count`` across
   the whole failover is asserted to be 0);
3. if every newly-dead device lies OUTSIDE the current active image the
   failure is *absorbed*: the sitting plan stays valid and training
   continues without a rewind;
4. otherwise restore the latest checkpoint (``verify=True`` — a corrupt
   snapshot raises before anything loads), flatten the parameters, seat
   them at the rewritten broadcast root (host row ``index_map[0]``) and
   replay the §5 program; every survivor row is asserted to equal the
   payload and the resumed parameters are REBUILT from a non-root
   survivor's row, proving they actually travelled the broadcast;
5. rebuild the step function for the shrunken D3(J, L) layout,
   restore the data-iterator state (typed ``DataState.from_dict``), rewind
   to the checkpoint step and keep stepping.

Because data, init and optimizer are deterministic, the post-failover loss
curve must match an uninterrupted run at equal data-state —
``max_loss_divergence`` measures exactly that and the drill asserts it.

The port of ``repro.train.elastic`` on the port's ``train`` modules. The
payload is the float32 ravel of the parameters, as in the reference; the
redistribution replays on the port's NumPy ``reference`` backend when
the model trains on the CPU, and on ``get_backend("cuda_fused")`` when it
trains on the card, whose broadcast is torch ops on an (n, P) tensor
there.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.topology import D3
from repro_torch.dist.mesh import DeviceLayout
from repro_torch.models.model import _device
from repro_torch.runtime.backends import get_backend
from repro_torch.runtime.backends.reference import NumpyReferenceBackend
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import DataState, SyntheticLM
from repro_torch.train.fault_tolerance import (
    ClusterState,
    RecoveryPlan,
    derivation_count,
)
from repro_torch.train.optimizer import OptConfig, flatten, unflatten
from repro_torch.train.train_step import TrainSettings, init_train_state, make_train_step


def ravel(params):
    """-> (the float32 concatenation of every leaf, unravel): ``unravel``
    of such a vector gives the tree back in the leaves' shapes and dtypes
    (bf16 through float32 and back is exact)."""
    leaves = [p for _, p in flatten(params)]
    vec = torch.cat([p.float().reshape(-1) for p in leaves])

    def unravel(v):
        out, lo = [], 0
        for p in leaves:
            out.append(v[lo:lo + p.numel()].reshape(p.shape).to(p.dtype).clone())
            lo += p.numel()
        return unflatten(params, out)

    return vec, unravel


@dataclasses.dataclass(frozen=True)
class FailoverEvent:
    """One failure's recovery record — what the drill and the benchmark
    inspect: the survivor shape, the broadcast accounting, the wall time
    from detection to resume, and the (must-be-zero) derivation count."""

    step: int                      # step at which the failure was detected
    failed: tuple[int, ...]        # newly-dead host device ids
    shape: tuple[int, int]         # survivor guest (J, L)
    survivors: tuple[int, ...]     # host ids in guest order (index_map values)
    resumed_from: int              # checkpoint step training rewound to
    broadcast_rounds: int          # rounds of the §5 redistribution program
    bytes_redistributed: int       # payload bytes moved per survivor
    wall_s: float                  # detection -> resume
    derivations: int               # derive+lower calls during failover (== 0)
    absorbed: bool                 # failure outside active image: no rewind


class FaultInjector:
    """Deterministic, consume-once failure schedule.

    Build from an explicit ``{step: [device_id, ...]}`` plan or sample one
    from a seed (``FaultInjector.sample``). ``take(step)`` returns the
    devices to kill at ``step`` exactly once: after a failover rewinds to
    the checkpoint and the loop passes the same step again, the injection
    does not re-fire (otherwise recovery would loop forever).
    """

    def __init__(self, plan: dict[int, list[int]] | None = None):
        self._plan = {
            int(s): tuple(int(d) for d in devs)
            for s, devs in (plan or {}).items()
        }
        self._fired: set[int] = set()

    @classmethod
    def sample(
        cls, host: D3, steps: int, failures: int, seed: int, *, min_step: int = 1
    ) -> "FaultInjector":
        """``failures`` distinct (step, device) kills, deterministic per
        seed: steps drawn without replacement from [min_step, steps),
        devices without replacement from the host pod (a device dies once)."""
        if failures > steps - min_step or failures > host.num_routers:
            raise ValueError("more failures than available steps or devices")
        rng = np.random.default_rng(seed)
        kill_steps = rng.choice(
            np.arange(min_step, steps), size=failures, replace=False)
        devices = rng.choice(host.num_routers, size=failures, replace=False)
        plan: dict[int, list[int]] = {}
        for s, d in zip(sorted(int(s) for s in kill_steps), devices):
            plan.setdefault(s, []).append(int(d))
        return cls(plan)

    @property
    def schedule(self) -> dict[int, tuple[int, ...]]:
        return dict(self._plan)

    def take(self, step: int) -> tuple[int, ...]:
        if step in self._fired:
            return ()
        devs = self._plan.get(int(step), ())
        if devs:
            self._fired.add(step)
        return devs


class ElasticTrainer:
    """The step loop of ``launch/train.py`` wrapped with failure injection
    and the rewrite-only recovery path. ``backend`` replays the
    redistribution broadcast (``run_broadcast(x, program)``); by default
    the NumPy reference backend when the model trains on the CPU and
    ``cuda_fused`` when it trains on the card. The model trains on
    ``device``."""

    def __init__(
        self,
        cfg,
        opt_cfg: OptConfig,
        settings: TrainSettings,
        *,
        ckpt_dir,
        host: D3 = D3(2, 2),
        injector: FaultInjector | None = None,
        backend=None,
        batch: int = 8,
        seq: int = 16,
        seed: int = 0,
        ckpt_every: int = 5,
        device="cuda",
    ):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.settings = settings
        self.ckpt_dir = str(ckpt_dir)
        self.injector = injector or FaultInjector()
        self.device = _device(device)
        if backend is None:
            backend = (get_backend("cuda_fused") if self.device.type == "cuda"
                       else NumpyReferenceBackend())
        self.backend = backend
        self.batch, self.seq, self.seed = batch, seq, seed
        self.ckpt_every = ckpt_every
        self.cluster = ClusterState(DeviceLayout(host))
        self.cluster.prepare_fallbacks()   # derive/lower paid here, once
        self.plan: RecoveryPlan | None = None  # sitting survivor plan
        self.events: list[FailoverEvent] = []
        self.losses: dict[int, float] = {}
        self._step_fn = None
        self._params = None
        self._opt_state = None
        self._data = None

    # ------------------------------------------------------------ plumbing
    def _build_step_fn(self):
        """A fresh step for the current (possibly shrunken) layout."""
        return make_train_step(self.cfg, self.opt_cfg, self.settings)

    def _active_devices(self) -> set[int]:
        if self.plan is None:
            return set(range(self.cluster.layout.topo.num_routers))
        return set(self.plan.index_map.values())

    def _save(self, step: int) -> str:
        return ckpt.save(
            self.ckpt_dir,
            step,
            {"params": self._params, "opt": self._opt_state,
             "data": self._data.state.to_dict()},
        )

    def _broadcast(self, payload: torch.Tensor, plan: RecoveryPlan, program):
        """The §5 program's replay with ``payload`` seated at the rewritten
        root's host row: every row of the result."""
        x = torch.zeros((program.n, payload.numel()), dtype=torch.float32,
                        device=payload.device)
        x[plan.index_map[0]] = payload        # rewritten root's host row
        if isinstance(self.backend, NumpyReferenceBackend):
            return torch.from_numpy(np.asarray(
                self.backend.run_broadcast(x.cpu().numpy(), program))).to(payload.device)
        return torch.as_tensor(self.backend.run_broadcast(x, program), device=payload.device)

    # ------------------------------------------------------------ failover
    def _failover(self, step: int, failed: tuple[int, ...]) -> int:
        """-> the step to resume from. Rewrite-only: the derivation-count
        delta across the whole failover is asserted to be zero."""
        t0 = time.perf_counter()
        d0 = derivation_count()
        active = self._active_devices()
        for dev in failed:
            self.cluster.fail(dev)
        plan = self.cluster.plan_recovery()   # lookup + relabel, no derive
        self.plan = plan
        survivors = tuple(plan.index_map[g] for g in sorted(plan.index_map))
        shape = (plan.layout.topo.K, plan.layout.topo.M)

        if not (set(failed) & active):
            # absorbed: the dead chips were already outside the image the
            # run is using — adopt the (possibly smaller) plan for future
            # collectives but keep stepping without a rewind.
            self.events.append(FailoverEvent(
                step=step, failed=tuple(failed), shape=shape,
                survivors=survivors, resumed_from=step, broadcast_rounds=0,
                bytes_redistributed=0, wall_s=time.perf_counter() - t0,
                derivations=derivation_count() - d0, absorbed=True,
            ))
            assert self.events[-1].derivations == 0, "failover re-derived"
            return step

        # -- rewind: checkpoint -> §5 broadcast redistribution -> rebuild ----
        ck_step, tree = ckpt.restore(self.ckpt_dir, verify=True)
        params = ckpt.to_device(tree["params"], self.device)
        payload, unravel = ravel(params)

        program = plan.programs["broadcast"]
        out = self._broadcast(payload, plan, program)
        for g, h in plan.index_map.items():
            if not torch.equal(out[h], payload):
                raise AssertionError(
                    f"survivor {h} (guest {g}) did not receive the payload")
        # resume from a NON-root survivor's row: the parameters the run
        # continues with demonstrably travelled the broadcast (on a
        # single-survivor plan the root is the only row there is).
        landing = plan.index_map[max(plan.index_map)]
        self._params = unravel(out[landing])
        del out
        self._opt_state = ckpt.to_device(tree["opt"], self.device)
        self._data = SyntheticLM(DataState.from_dict(tree["data"]))
        self._step_fn = self._build_step_fn()

        self.events.append(FailoverEvent(
            step=step, failed=tuple(failed), shape=shape,
            survivors=survivors, resumed_from=ck_step,
            broadcast_rounds=program.num_rounds,
            bytes_redistributed=payload.numel() * payload.element_size(),
            wall_s=time.perf_counter() - t0,
            derivations=derivation_count() - d0, absorbed=False,
        ))
        assert self.events[-1].derivations == 0, "failover re-derived"
        return ck_step

    # ----------------------------------------------------------- main loop
    def run(self, steps: int) -> dict[int, float]:
        """Train ``steps`` steps, surviving every injected failure; ->
        {step: loss} with post-failover steps overwriting their rewound
        predecessors (identical values when recovery is exact)."""
        self._params, self._opt_state = init_train_state(
            self.seed, self.cfg, self.opt_cfg, self.settings, device=self.device)
        self._data = SyntheticLM(DataState(
            seed=self.seed, batch=self.batch, seq=self.seq,
            vocab=self.cfg.vocab))
        self._step_fn = self._build_step_fn()
        self._save(0)   # step-0 snapshot: failures before the first
        # periodic checkpoint must still be recoverable

        step = 0
        while step < steps:
            failed = self.injector.take(step)
            if failed:
                step = self._failover(step, failed)
                continue
            if self.cfg.embeds_input:
                batch = self._data.next_embeds_batch(self.cfg.d_model)
            else:
                batch = self._data.next_batch()
            batch = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
            self._params, self._opt_state, metrics = self._step_fn(
                self._params, self._opt_state, batch)
            self.losses[step] = float(metrics["loss"])
            step += 1
            if step % self.ckpt_every == 0 or step == steps:
                self._save(step)
        return dict(self.losses)


def max_loss_divergence(a: dict[int, float], b: dict[int, float]) -> float:
    """Largest |a[s] - b[s]| over the common steps — the loss-continuity
    metric: an elastic run vs. an uninterrupted run of the same seed must
    agree everywhere, failovers included."""
    common = sorted(set(a) & set(b))
    if not common:
        raise ValueError("no common steps to compare")
    return max(abs(a[s] - b[s]) for s in common)
