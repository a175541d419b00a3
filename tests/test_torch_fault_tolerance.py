"""``train.fault_tolerance`` of the port against the JAX package's.

Both packages build the same clusters, fail the same devices and admit,
evict and release the same tenants; what comes out must be equal: the
guest shapes and embeddings, the index maps, the surviving and evicted
tenants, and every program and schedule stage by stage (the signatures of
``test_torch_emulation``: pairs, stamps and tables as lists). The
straggler policy's verdicts and the renormalized scale are compared on
the same durations. Recovery and eviction are rewrite-only in the port
too: with the port's core derivations and lowering replaced by a function
that raises, ``plan_recovery`` and ``plan_eviction`` still answer. All
host code: exact comparisons, no tolerance.
"""

import types

import numpy as np
import pytest

from repro.core import emulation as j_emu
from repro.core.topology import D3 as JD3
from repro.dist.mesh import DeviceLayout as JLayout
from repro.train import fault_tolerance as j_ft

from repro_torch.core import alltoall as t_a2a
from repro_torch.core import broadcast as t_bc
from repro_torch.core import emulation as t_emu
from repro_torch.core import hypercube as t_hc
from repro_torch.core import matmul as t_mm
from repro_torch.core.topology import D3 as TD3
from repro_torch.dist.mesh import DeviceLayout as TLayout
from repro_torch.runtime import lowering as t_lowering
from repro_torch.train import fault_tolerance as t_ft

from test_torch_emulation import plain, program_signature

J = types.SimpleNamespace(D3=JD3, Layout=JLayout, emu=j_emu, ft=j_ft)
T = types.SimpleNamespace(D3=TD3, Layout=TLayout, emu=t_emu, ft=t_ft)


def schedule_signature(s):
    return (s.name, [([(h.step, h.src, h.dst, h.payload) for h in r.hops],
                      sorted(((k, plain(v)) for k, v in r.meta.items()), key=str))
                     for r in s.rounds])


def embedding_signature(e):
    return ((e.host.K, e.host.M), (e.guest.K, e.guest.M), tuple(e.c_set), tuple(e.p_set),
            [int(h) for h in e.device_map])


def suite_signature(suite):
    return (suite.root, sorted(suite.programs),
            {k: program_signature(p) for k, p in suite.programs.items()},
            {k: schedule_signature(s) for k, s in suite.schedules.items()})


def recovery_signature(plan):
    return ((plan.layout.topo.K, plan.layout.topo.M), embedding_signature(plan.embedding),
            plan.index_map,
            {k: program_signature(p) for k, p in plan.programs.items()},
            {k: schedule_signature(s) for k, s in plan.schedules.items()})


def tenant_signature(plan):
    return (plan.surviving, plan.evicted, [embedding_signature(e) for e in plan.embeddings],
            {k: program_signature(p) for k, p in plan.programs.items()}, plan.index_maps)


LAYOUTS = [(1, 1), (1, 2), (2, 1), (2, 2), (3, 2), (4, 2), (3, 3), (4, 4)]


@pytest.mark.parametrize("shape", LAYOUTS, ids=[f"D3{s}" for s in LAYOUTS])
def test_lower_layout_programs_equals_the_reference(shape):
    """The derive-once suite of every kind the shape supports, program by
    program and schedule by schedule; each build counts one derivation."""
    sigs = []
    for pkg in (J, T):
        before = pkg.ft.derivation_count()
        suite = pkg.ft.lower_layout_programs(pkg.Layout(pkg.D3(*shape)), root=0)
        assert pkg.ft.derivation_count() == before + 1
        sigs.append(suite_signature(suite))
    assert sigs[0] == sigs[1]


def _striped(pkg, host):
    """Every cabinet's router (c, 0, 0) fails."""
    topo = pkg.D3(*host)
    return [topo.router_id((c, 0, 0)) for c in range(host[0])]


#: name -> (host, the failed devices (a function of the package), shapes to prepare or None)
FAILURES = {
    "D3(4,4)-one": ((4, 4), lambda pkg: [5], None),
    "D3(3,3)-striped": ((3, 3), lambda pkg: _striped(pkg, (3, 3)), None),
    "D3(4,2)-two": ((4, 2), lambda pkg: [0, 13], None),
    "D3(2,2)-prepared-one": ((2, 2), lambda pkg: [7], [(1, 2)]),
}


@pytest.mark.parametrize("name", list(FAILURES))
def test_plan_recovery_equals_the_reference(name):
    """The survivor network, its embedding and index map, and the rewritten
    programs and host-graph schedules of the plan."""
    host, failed, shapes = FAILURES[name]
    sigs = []
    for pkg in (J, T):
        cluster = pkg.ft.ClusterState(pkg.Layout(pkg.D3(*host)))
        cluster.prepare_fallbacks(shapes)
        for dev in failed(pkg):
            cluster.fail(dev)
        plan = cluster.plan_recovery()
        dead = {cluster.layout.topo.router_id(r) for r in cluster.dead}
        assert dead.isdisjoint(plan.index_map.values())
        for prog in plan.programs.values():
            assert prog.n == cluster.layout.n
            assert prog.active_devices == tuple(plan.embedding.device_map)
        sigs.append((recovery_signature(plan), cluster.fallback_shapes(), sorted(cluster.library)))
    assert sigs[0] == sigs[1]


def test_plan_recovery_requires_preparation_and_one_root():
    for pkg in (J, T):
        cluster = pkg.ft.ClusterState(pkg.Layout(pkg.D3(4, 4)))
        cluster.fail(5)
        with pytest.raises(pkg.ft.UnpreparedShapeError, match="prepare_fallbacks"):
            cluster.plan_recovery()
        suite = cluster.prepare_shape(2, 2, root=3)
        assert suite.root == 3 and cluster.prepare_shape(2, 2, root=3) is suite
        with pytest.raises(ValueError, match="broadcast root"):
            cluster.prepare_shape(2, 2)


def _boom(*a, **k):
    raise AssertionError("the recovery path called into a core derivation")


def _no_derivations(monkeypatch):
    for module, name in ((t_a2a, "schedule"), (t_mm, "schedule"), (t_bc, "depth3_schedule"),
                         (t_hc, "allreduce_schedule"), (t_lowering, "lower")):
        monkeypatch.setattr(module, name, _boom)


def test_port_recovery_and_eviction_are_rewrite_only(monkeypatch):
    """With every core derivation and the lowering raising, the prepared
    port still plans a recovery and an eviction."""
    cluster = t_ft.ClusterState(TLayout(TD3(4, 4)))
    cluster.prepare_fallbacks()
    mt = t_ft.MultiTenantCluster(TLayout(TD3(4, 4)))
    for e in t_emu.disjoint_embeddings(TD3(4, 4), [(2, 2), (2, 2)]):
        mt.admit(e)
    before = t_ft.derivation_count()
    _no_derivations(monkeypatch)
    cluster.fail(5)
    assert set(cluster.plan_recovery().programs) >= {"alltoall", "broadcast"}
    mt.fail(int(mt.tenants[1].device_map[2]))
    assert mt.plan_eviction().surviving == (0,)
    assert t_ft.derivation_count() == before


def _multitenant_drill(pkg):
    """The reference's multi-tenant scenario (``tests/test_combine.py``),
    step by step; returns what each step gave."""
    host = pkg.D3(4, 4)
    embs = pkg.emu.disjoint_embeddings(host, [(2, 2), (2, 2)])
    mt = pkg.ft.MultiTenantCluster(pkg.Layout(host))
    out = {"admit": [mt.admit(e) for e in embs]}
    with pytest.raises(ValueError, match="overlaps"):
        mt.admit(pkg.emu.embed(host, 2, 2, c_set=(1, 2), p_set=(0, 1)))
    out["healthy"] = tenant_signature(mt.plan_eviction())
    out["kinds"] = sorted(mt.plan_eviction(kinds=["alltoall", "matmul"]).programs)
    mt.fail(int(embs[1].device_map[2]))
    out["evicted"] = tenant_signature(mt.plan_eviction())
    out["seated"] = [embedding_signature(e) for e in mt.tenants]
    out["replacement"] = mt.admit(pkg.emu.embed(host, 2, 2, c_set=(2, 3), p_set=(2, 3)))
    out["after_replacement"] = tenant_signature(mt.plan_eviction())
    out["release"] = tenant_signature(mt.release(0))
    out["release_last"] = tenant_signature(mt.release(0))
    with pytest.raises(IndexError, match="out of range"):
        mt.release(0)
    fresh = pkg.ft.MultiTenantCluster(pkg.Layout(host))
    fresh.fail(int(embs[1].device_map[2]))
    with pytest.raises(ValueError, match="failed host devices"):
        fresh.admit(embs[1])
    with pytest.raises(ValueError, match="embeds into"):
        fresh.admit(pkg.emu.embed(pkg.D3(2, 2), 1, 2))
    both = pkg.ft.MultiTenantCluster(pkg.Layout(host))
    for e in embs:
        both.admit(e)
        for h in e.device_map:
            both.dead.add(host.id_router(int(h)))
    with pytest.raises(RuntimeError, match="no tenant"):
        both.plan_eviction()
    return out


def test_multitenant_admit_evict_release_equal_the_reference():
    """Admission, the overlap and failed-device refusals, failure-driven
    eviction, a replacement on the freed cabinets, voluntary release down
    to no tenant: the same plans, programs and seats in both packages."""
    j, t = _multitenant_drill(J), _multitenant_drill(T)
    assert j.keys() == t.keys()
    for key in j:
        assert j[key] == t[key], key
    assert t["evicted"][:2] == ((0,), (1,)) and t["release_last"][3] == {}


def test_multitenant_survivor_keeps_its_solo_program():
    """The survivor's combined program is its cached solo rewrite (the
    combine of one program is the program)."""
    from repro_torch.runtime.rewrite import emulate

    host = TD3(4, 4)
    embs = t_emu.disjoint_embeddings(host, [(2, 2), (2, 2)])
    mt = t_ft.MultiTenantCluster(TLayout(host))
    for e in embs:
        mt.admit(e)
    mt.fail(int(embs[1].device_map[0]))
    plan = mt.plan_eviction()
    assert plan.programs["alltoall"] is emulate(mt.library[(2, 2)].programs["alltoall"], embs[0])


DURATIONS = [[], [1.0], [1.0, 1.1, 0.9, 5.0], [1.0, 10.0, 11.0, 12.0], [0.0, 0.0, 0.0],
             [2.0, 2.0, 6.1, 2.0, 2.0], [3.0, 1.0, 2.0, 9.5, 1.5, 2.5, 30.0, 2.0]]


@pytest.mark.parametrize("factor,least", [(3.0, 0.75), (2.0, 0.75), (1.5, 0.5)])
def test_straggler_policy_and_scale_equal_the_reference(factor, least):
    for durations in DURATIONS:
        j = j_ft.StragglerPolicy(deadline_factor=factor, min_participants=least).judge(durations)
        t = t_ft.StragglerPolicy(deadline_factor=factor, min_participants=least).judge(durations)
        assert t == j, durations
    for kept, total in ((3, 4), (0, 4), (4, 4), (7, 8)):
        assert t_ft.renormalized_scale(kept, total) == j_ft.renormalized_scale(kept, total)
    assert np.isclose(t_ft.renormalized_scale(3, 4), 4 / 3)
