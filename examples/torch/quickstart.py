"""Quickstart: the paper's four algorithms in 60 seconds, through the
PyTorch port's ``repro_torch.core`` (host NumPy: no device).

    PYTHONPATH=src python examples/torch/quickstart.py

It prints the lines of ``examples/quickstart.py``, the JAX package's
quickstart.
"""

import argparse

import numpy as np

from repro_torch.core.alltoall import DAParams, pipeline, verify_vector_coverage
from repro_torch.core.broadcast import check_m_broadcast, m_broadcast
from repro_torch.core.hypercube import SBH, check_allreduce_conflicts, simulate_allreduce
from repro_torch.core.matmul import MatmulGrid, simulate_matmul
from repro_torch.core.simulator import check_vector_round
from repro_torch.core.topology import D3


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)

    # ---- the network
    t = D3(K=4, M=8)  # 4 * 8² = 256 routers
    print(f"D3(4,8): {t.num_routers} routers, "
          f"{t.num_local_links} local + {t.num_global_links} global links")

    # ---- A1: matrix product on D3(K²,M) (Theorem 1)
    g = MatmulGrid(K=2, M=3)
    rng = np.random.default_rng(0)
    B = rng.standard_normal((g.n, g.n))
    A = rng.standard_normal((g.n, g.n))
    C = simulate_matmul(g, B, A)
    print(f"A1 matmul on D3({g.K**2},{g.M}): {g.n}x{g.n} in {g.n} rounds of 4 hops, "
          f"max err {np.abs(C - B @ A).max():.2e}")

    # ---- A2: doubly-parallel all-to-all (Theorem 3)
    p = DAParams(4, 8, 4)  # s = gcd(4, 8) = 4
    verify_vector_coverage(p)
    rep = pipeline(p, offset=3)
    print(f"A2 all-to-all on D3(4,8): {p.total_rounds} rounds (= KM²/s), "
          f"schedule-3 makespan {rep.total_steps} hops, 0 conflicts")

    # ---- conflict-freedom is machine-checked, not assumed
    sends = [(r, (1, 2, 3)) for r in t.routers()]
    conflicts, _ = check_vector_round(t, sends)
    print(f"P1 check: {len(sends)} simultaneous sends, {len(conflicts)} link conflicts")

    # ---- A3: hypercube emulation (ascend all-reduce at ~2x)
    s = SBH(2, 2)  # 64-node D3(4,4) emulating the 6-cube
    vals = rng.standard_normal(s.num_nodes)
    out = simulate_allreduce(s, vals)
    confs, steps = check_allreduce_conflicts(s)
    print(f"A3 SBH(2,2) all-reduce over {s.dims} dims: {steps} hops "
          f"(native {s.dims}), {len(confs)} conflicts, "
          f"err {np.abs(out - vals.sum()).max():.2e}")

    # ---- A4: M simultaneous broadcasts in 5 hops
    confs = check_m_broadcast(t, (0, 0, 0))
    hops = m_broadcast(t, (0, 0, 0))
    print(f"A4 m-broadcast on D3(4,8): {t.M} broadcasts in "
          f"{1 + max(s for s, _, _ in hops)} hops, {len(confs)} conflicts")


if __name__ == "__main__":
    main()
