"""Derivation parity of the port with the JAX package: schedules, verify()
verdicts, lowered programs and fused tables, over small D3(K, M) shapes.

The port's core, lowering and table layers are copies of the reference's
pure-Python modules; these tests hold every value they derive equal to the
reference's, so a drift in derivation fails here and not in the replay
tests (``test_torch_runtime.py``). Nothing here touches a device.
"""

import dataclasses
import math

import numpy as np
import pytest

from repro.core import alltoall as j_a2a
from repro.core import broadcast as j_bc
from repro.core import costmodel as j_cost
from repro.core import emulation as j_emu
from repro.core import hypercube as j_hc
from repro.core import matmul as j_mm
from repro.core import simulator as j_sim
from repro.core.topology import D3 as JD3
from repro.dist.collectives import (
    allreduce_program as j_allreduce_program,
    alltoall_program as j_alltoall_program,
    broadcast_program as j_broadcast_program,
    matmul_program as j_matmul_program,
)
from repro.dist.mesh import DeviceLayout as JLayout, dragonfly_layout as j_dragonfly_layout
from repro.runtime import lowering as j_lowering
from repro.runtime import optimize as j_opt

from repro_torch.core import alltoall as t_a2a
from repro_torch.core import broadcast as t_bc
from repro_torch.core import costmodel as t_cost
from repro_torch.core import emulation as t_emu
from repro_torch.core import hypercube as t_hc
from repro_torch.core import matmul as t_mm
from repro_torch.core import simulator as t_sim
from repro_torch.core.topology import D3 as TD3
from repro_torch.dist import collectives as t_dc
from repro_torch.dist.mesh import DeviceLayout as TLayout, dragonfly_layout as t_dragonfly_layout
from repro_torch.runtime import lowering as t_lowering
from repro_torch.runtime import optimize as t_opt

SHAPES = [(1, 2), (2, 2), (2, 4), (4, 2)]
GRIDS = [(1, 2), (2, 2)]
STAGE_ARRAYS = ("sigma_np", "inverse_np", "src_np", "dst_np", "dst_mask_np",
                "self_mask_np", "mask_np", "link_pairs")


def canon(obj):
    """A package-neutral value: dataclasses become (class name, fields...),
    so equal derivations from the two packages compare equal."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            canon(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    if isinstance(obj, dict):
        return tuple((k, canon(obj[k])) for k in sorted(obj, key=repr))
    if isinstance(obj, (list, tuple)):
        return tuple(canon(v) for v in obj)
    if isinstance(obj, (set, frozenset)):
        return ("set",) + tuple(sorted((canon(v) for v in obj), key=repr))
    if isinstance(obj, np.ndarray):
        return ("ndarray", obj.dtype.str, obj.shape, obj.tobytes())
    return obj


def schedules(K, M):
    """Every schedule the slice lowers, from both packages, on D3(K, M)."""
    jt, tt = JD3(K, M), TD3(K, M)
    jp = j_a2a.DAParams(K, M, math.gcd(K, M))
    tp = t_a2a.DAParams(K, M, math.gcd(K, M))
    out = {
        "alltoall": (j_a2a.schedule(jp, jt), t_a2a.schedule(tp, tt)),
        "depth3": (j_bc.depth3_schedule(jt, (0, 1 % M, 0)),
                   t_bc.depth3_schedule(tt, (0, 1 % M, 0))),
    }
    for offset in (1, 2, 3):
        out[f"pipelined{offset}"] = (j_a2a.pipelined_schedule(jp, offset, jt),
                                     t_a2a.pipelined_schedule(tp, offset, tt))
    if JLayout(jt).sbh is not None:
        out["allreduce"] = (j_hc.allreduce_schedule(JLayout(jt).sbh),
                            t_hc.allreduce_schedule(TLayout(tt).sbh))
    return out


def _stage_array(stage, attr):
    """A stage's cached index array, or the refusal it raises (a
    ReduceCombine's inverse exists only for full permutations)."""
    try:
        return canon(np.asarray(getattr(stage, attr)))
    except ValueError as err:
        return ("raises", str(err))


def assert_programs_equal(jp, tp):
    assert canon(jp) == canon(tp)
    for js, ts in zip(jp.stages, tp.stages):
        for attr in STAGE_ARRAYS:
            if attr in dir(type(js)):
                assert _stage_array(ts, attr) == _stage_array(js, attr), attr


def assert_tables_equal(jo, to):
    assert to.uniform_rounds == jo.uniform_rounds
    assert [type(op).__name__ for op in to.ops] == [type(op).__name__ for op in jo.ops]
    assert canon(to.ops) == canon(jo.ops)


@pytest.mark.parametrize("km", SHAPES, ids=str)
def test_schedules_equal_round_by_round(km):
    for name, (js, ts) in schedules(*km).items():
        assert len(ts.rounds) == len(js.rounds), name
        for jr, tr in zip(js.rounds, ts.rounds):
            assert canon(tr) == canon(jr), name
        assert canon(ts) == canon(js), name


@pytest.mark.parametrize("km", SHAPES, ids=str)
@pytest.mark.parametrize("pipelined", [False, True])
def test_verify_verdicts_equal(km, pipelined):
    for name, (js, ts) in schedules(*km).items():
        jr = j_sim.verify(JD3(*km), js, pipelined=pipelined)
        tr = t_sim.verify(TD3(*km), ts, pipelined=pipelined)
        assert canon(tr) == canon(jr), name
        if not pipelined or name.startswith("pipelined"):
            assert tr.ok, name


@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_matmul_schedule_and_verdict_equal(grid):
    js, ts = j_mm.schedule(j_mm.MatmulGrid(*grid)), t_mm.schedule(t_mm.MatmulGrid(*grid))
    assert canon(ts) == canon(js)
    jr = j_sim.verify(j_mm.MatmulGrid(*grid).topo, js)
    tr = t_sim.verify(t_mm.MatmulGrid(*grid).topo, ts)
    assert canon(tr) == canon(jr) and tr.ok


@pytest.mark.parametrize("km", SHAPES, ids=str)
def test_lowered_programs_equal(km):
    for name, (js, ts) in schedules(*km).items():
        assert_programs_equal(j_lowering.lower(js), t_lowering.lower(ts))


@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_lowered_matmul_programs_equal(grid):
    assert_programs_equal(j_matmul_program(*grid), t_dc.matmul_program(*grid))


@pytest.mark.parametrize("km", SHAPES, ids=str)
def test_fused_tables_equal(km):
    jl, tl = JLayout(JD3(*km)), TLayout(TD3(*km))
    pairs = [(j_alltoall_program(jl, optimized=True), t_dc.alltoall_program(tl, optimized=True)),
             (j_alltoall_program(jl, optimized=True, pipelined=2),
              t_dc.alltoall_program(tl, optimized=True, pipelined=2)),
             (j_broadcast_program(jl, tl.n - 1, optimized=True),
              t_dc.broadcast_program(tl, tl.n - 1, optimized=True))]
    if jl.sbh is not None:
        pairs.append((j_allreduce_program(jl, optimized=True),
                      t_dc.allreduce_program(tl, optimized=True)))
    for jo, to in pairs:
        assert_programs_equal(jo.program, to.program)
        assert_tables_equal(jo, to)


@pytest.mark.parametrize("km", SHAPES, ids=str)
def test_stacked_combine_tables_equal(km):
    jo = j_allreduce_program(JLayout(JD3(*km)), optimized=True)
    to = t_dc.allreduce_program(TLayout(TD3(*km)), optimized=True)
    for jt, tt in zip(j_opt.stacked_combine_tables(jo), t_opt.stacked_combine_tables(to)):
        assert tt.dtype == jt.dtype
        np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("grid", GRIDS + [(1, 3)], ids=str)
def test_fused_matmul_tables_and_block_index_equal(grid):
    jo, to = j_matmul_program(*grid, optimized=True), t_dc.matmul_program(*grid, optimized=True)
    assert_tables_equal(jo, to)
    for jb, tb in zip(j_opt._block_index(grid), t_opt._block_index(grid)):
        np.testing.assert_array_equal(tb, jb)


@pytest.mark.parametrize("n", [4, 8, 16, 18, 32, 64, 256])
def test_dragonfly_layout_equal(n):
    jl, tl = j_dragonfly_layout(n), t_dragonfly_layout(n)
    assert (tl.topo.K, tl.topo.M) == (jl.topo.K, jl.topo.M)
    assert canon(tl.da_params) == canon(jl.da_params)
    assert canon(tl.sbh) == canon(jl.sbh)


@pytest.mark.parametrize("host,guest", [((2, 4), (2, 2)), ((4, 4), (2, 2)), ((4, 2), (1, 2))],
                         ids=str)
def test_embeddings_equal(host, guest):
    je, te = j_emu.embed(JD3(*host), *guest), t_emu.embed(TD3(*host), *guest)
    np.testing.assert_array_equal(te.device_map, je.device_map)
    dead = {(0, 0, 0), (1, 1, 1)}
    assert canon(t_emu.largest_embeddable(TD3(*host), dead)) == \
        canon(j_emu.largest_embeddable(JD3(*host), dead))


# ------------------------------------------------------------- cost model
PRICES = [(1.0, 0.0), (1.0, 1.0), (2.5e-6, 7e-6)]  # (t_w, t_s)


@pytest.mark.parametrize("km", SHAPES, ids=str)
def test_costmodel_prices_every_schedule_alike(km):
    """``price`` and ``price_pipelined`` of every schedule the slice
    lowers, and of the §2 schedules, equal the JAX package's."""
    pairs = list(schedules(*km).values()) + [
        (j_mm.schedule(j_mm.MatmulGrid(*g)), t_mm.schedule(t_mm.MatmulGrid(*g))) for g in GRIDS]
    for js, ts in pairs:
        for t_w, t_s in PRICES:
            assert t_cost.price(ts, t_w, t_s) == j_cost.price(js, t_w, t_s)
            assert t_cost.price_pipelined(ts, t_w, t_s) == j_cost.price_pipelined(js, t_w, t_s)
        assert t_cost.price(ts) == j_cost.price(js)
        assert t_cost.price_pipelined(ts) == j_cost.price_pipelined(js)


@pytest.mark.parametrize("km", SHAPES, ids=str)
def test_costmodel_tables_alike(km):
    """The §2–§5 table formulas at the sweep's shapes (P = K·M² routers,
    s = gcd(K, M), k and m their base-2 logs where they are powers of 2)."""
    K, M = km
    P, s = K * M * M, math.gcd(K, M)
    assert t_cost.MATMUL_TABLE.keys() == j_cost.MATMUL_TABLE.keys()
    for name, fn in t_cost.MATMUL_TABLE.items():
        for n in (P, 4 * P, 1000):
            assert fn(n, P) == j_cost.MATMUL_TABLE[name](n, P), name
    for fn in ("alltoall_schedule1", "alltoall_schedule2", "alltoall_schedule3"):
        assert getattr(t_cost, fn)(K, M, s) == getattr(j_cost, fn)(K, M, s), fn
    for n in (None, 2 * P):
        assert t_cost.alltoall_doubly_parallel(K, M, s, n) == \
            j_cost.alltoall_doubly_parallel(K, M, s, n)
        assert t_cost.alltoall_johnsson_ho(P, n) == j_cost.alltoall_johnsson_ho(P, n)
    k, m = K.bit_length() - 1, M.bit_length() - 1
    assert t_cost.alltoall_jh_on_sbh(k, m) == j_cost.alltoall_jh_on_sbh(k, m)
    assert t_cost.alltoall_dp_on_d3_2k2m(k, m) == j_cost.alltoall_dp_on_d3_2k2m(k, m)
    for X in (M, 16, 1024):
        assert t_cost.broadcast_depth3(X) == j_cost.broadcast_depth3(X)
        assert t_cost.broadcast_m_tree(X, M) == j_cost.broadcast_m_tree(X, M)


@pytest.mark.parametrize("km", SHAPES, ids=str)
def test_costmodel_seconds_alike_with_the_bandwidth_named(km):
    """``seconds`` of each schedule's hop count, the bandwidth passed to
    both (the port's has no default: the JAX package's is a TPU link's)."""
    for _, ts in schedules(*km).values():
        hops = t_cost.price(ts)
        for t_w, t_s in PRICES:
            for nbytes, bw in ((0.0, 1e9), (1 << 20, 450e9), (4096.0, 25e9)):
                assert t_cost.seconds(hops, t_w, t_s, bytes_per_hop=nbytes, bandwidth=bw) == \
                    j_cost.seconds(hops, t_w, t_s, bytes_per_hop=nbytes, bandwidth=bw)
    with pytest.raises(TypeError, match="bandwidth"):
        t_cost.seconds(1.0)
