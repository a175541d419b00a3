"""Elastic failover demo, through the PyTorch port — paper Property 2 as
a fault-tolerance mechanism.

Simulates chip failures on a D3(4,8) pod. At bring-up the cluster derives
and lowers the algorithm suite for every fallback shape ONCE
(``prepare_fallbacks``). When chips die, ``plan_recovery`` finds the
largest embeddable D3(J,L) survivor network and REWRITES the already-
lowered guest programs onto it (``runtime.rewrite.emulate``): the
recovery path never calls back into the core schedule derivations.

The demo then proves the rewrite is sound twice over:

  * conflict-freedom: the rewritten schedule replays through
    ``core.simulator.verify`` on the literal HOST graph (dilation-1 ⇒
    zero conflicts);
  * bit-exactness: the rewritten all-to-all program replays on the
    ``reference`` backend against the natively-lowered guest program, and
    then on EVERY registered backend (``runtime.backends``): each one must
    reproduce the reference bits on the optimized rewritten program.

    PYTHONPATH=src python examples/torch/elastic_failover.py [--device cpu]

The backends that run on a device (``cuda_fused``, ``torch_dist``'s
whole-array replay and ``auto``, whose autotuner measures there with its
cache in a temporary directory) take ``--device``: the card by default.
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.core.simulator import verify
from repro_torch.core.topology import D3
from repro_torch.dist.mesh import DeviceLayout
from repro_torch.runtime.autotune import Autotuner
from repro_torch.runtime.backends import available_backends, get_backend
from repro_torch.runtime.backends.reference import NumpyReferenceBackend
from repro_torch.runtime.optimize import optimize
from repro_torch.runtime.rewrite import gather_guest, scatter_guest
from repro_torch.train.fault_tolerance import ClusterState

#: the backends that replay NumPy arrays on the host; every other takes
#: the input as a tensor on the device
HOST_BACKENDS = ("reference", "sendrecv")


def replay_everywhere(xh, opt, want, device, cache_dir):
    """Replay the optimized program ``opt`` on ``xh`` with every registered
    backend and check each against ``want`` bit for bit."""
    kwargs = {"cuda_fused": {"device": device},
              "auto": {"device": device, "tuner": Autotuner(cache_path=f"{cache_dir}/auto.json",
                                                            device=device)}}
    for name in available_backends():
        backend = get_backend(name, **kwargs.get(name, {}))
        x = xh if name in HOST_BACKENDS else torch.as_tensor(xh, device=device)
        out = backend.run_alltoall(x, opt)
        out = out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
        np.testing.assert_array_equal(out, want)
        print(f"  backend {name:13s} ({type(backend).__name__}) "
              "replays the optimized rewrite bit-exact ✓")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the device backends (cuda by default; cpu runs "
                         "their plain torch path)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    layout = DeviceLayout(D3(4, 8))
    cluster = ClusterState(layout)
    print(f"healthy pod: D3(4,8) = {layout.n} chips, "
          f"all-to-all rounds = {layout.da_params.total_rounds}")

    # bring-up: derive + lower every fallback shape once (the only time the
    # core algorithm derivations run)
    cluster.prepare_fallbacks()
    print(f"program library prepared: {len(cluster.library)} guest shapes, "
          f"{sum(len(s.programs) for s in cluster.library.values())} lowered programs")

    # two chips die on different cabinets
    for dev in (37, 201):
        cluster.fail(dev)
        print(f"chip {dev} = router {layout.topo.id_router(dev)} FAILED")

    plan = cluster.plan_recovery()  # rewrite-only: lookup + relabel
    guest = plan.layout.topo
    print(f"largest embeddable survivor network: D3({guest.K},{guest.M}) "
          f"= {plan.layout.n} chips (c_set={plan.embedding.c_set}, "
          f"p_set={plan.embedding.p_set})")
    print(f"rewritten programs: {sorted(plan.programs)} — "
          f"{sum(p.num_permutes for p in plan.programs.values())} total comm stages, "
          "zero re-derivations")

    # conflict-freedom on the HOST links: replay every rewritten schedule
    # through the unified simulator (dilation-1 ⇒ nothing may collide)
    for kind, sched in sorted(plan.schedules.items()):
        report = verify(layout.topo, sched).raise_on_conflict(f"rewritten {kind}")
        print(f"  {kind:9s} conflict-free on host links "
              f"({report.num_rounds} rounds, {report.num_hop_events} hop events)")

    # bit-exactness: rewritten-on-host all-to-all == natively-lowered guest
    ref = NumpyReferenceBackend()
    native = cluster.library[(guest.K, guest.M)].programs["alltoall"]
    rewritten = plan.programs["alltoall"]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((native.n, native.n, 4)).astype(np.float32)
    want = ref.run_alltoall(x, native)
    got = gather_guest(
        ref.run_alltoall(scatter_guest(x, rewritten, axes=(0, 1)), rewritten),
        rewritten, axes=(0, 1),
    )
    np.testing.assert_array_equal(got, want)
    print("rewritten all-to-all bit-exact vs native guest lowering ✓")

    # every registered backend replays the (optimized) rewritten program to
    # the same bits: the registry is the source of truth, not a stale list
    xh = scatter_guest(x, rewritten, axes=(0, 1))
    with tempfile.TemporaryDirectory() as cache_dir:
        replay_everywhere(xh, optimize(rewritten), ref.run_alltoall(xh, rewritten), device,
                          cache_dir)
    print(f"device remap entries: {len(plan.index_map)} (guest id -> surviving host id)")


if __name__ == "__main__":
    main()
