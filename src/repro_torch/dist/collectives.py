"""The paper's four algorithms as cached collective programs.

Each getter emits the §2–§5 schedule from its core algorithm module as a
``Schedule``, lowers it once per layout with ``runtime.lowering.lower``
into a backend-neutral ``CollectiveProgram`` (cached — lowering is pure
Python) and, with ``optimized=True``, returns the ``runtime.optimize``
fused-table form instead. Whole-array callers hand either form to a
backend's ``run_*``:

    from repro_torch.dist.collectives import allreduce_program
    from repro_torch.dist.mesh import dragonfly_layout
    from repro_torch.runtime.backends import get_backend

    prog = allreduce_program(dragonfly_layout(64), optimized=True)
    y = get_backend("cuda_fused").run_allreduce(x, prog)

Device index i is router ``layout.topo.id_router(i)``.
"""

from __future__ import annotations

import functools

from repro_torch.core import alltoall as a2a
from repro_torch.core import broadcast as bc
from repro_torch.core import hypercube as hc
from repro_torch.core import matmul as mm
from repro_torch.dist.mesh import DeviceLayout
from repro_torch.runtime import lowering
from repro_torch.runtime.optimize import optimize
from repro_torch.runtime.program import CollectiveProgram


@functools.lru_cache(maxsize=None)
def alltoall_program(
    layout: DeviceLayout, *, optimized: bool = False, pipelined: int = 0,
) -> CollectiveProgram:
    """``pipelined=0`` lowers the barrier §3 schedule (every stage stamped
    start_step 0). ``pipelined=offset >= 1`` lowers the Schedule-``offset``
    pipelined variant instead: stages carry the ``round_starts`` launch
    stamps."""
    sched = (a2a.pipelined_schedule(layout.da_params, pipelined, layout.topo)
             if pipelined else a2a.schedule(layout.da_params, layout.topo))
    prog = lowering.lower(sched)
    return optimize(prog) if optimized else prog


@functools.lru_cache(maxsize=None)
def allreduce_program(
    layout: DeviceLayout, *, optimized: bool = False,
) -> CollectiveProgram:
    sbh = layout.sbh
    if sbh is None:
        raise ValueError(
            f"D3({layout.topo.K},{layout.topo.M}) is not a power-of-two SBH; "
            "no hypercube all-reduce schedule exists"
        )
    prog = lowering.lower(hc.allreduce_schedule(sbh))
    return optimize(prog) if optimized else prog


@functools.lru_cache(maxsize=None)
def broadcast_program(
    layout: DeviceLayout, root: int, *, optimized: bool = False,
) -> CollectiveProgram:
    prog = lowering.lower(
        bc.depth3_schedule(layout.topo, layout.topo.id_router(root))
    )
    return optimize(prog) if optimized else prog


@functools.lru_cache(maxsize=None)
def matmul_program(
    K: int, M: int, *, optimized: bool = False,
) -> CollectiveProgram:
    """§2 program for the K×K array of M×M blocks (K²M² devices)."""
    prog = lowering.lower(mm.schedule(mm.MatmulGrid(K, M)))
    return optimize(prog) if optimized else prog
