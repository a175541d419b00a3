"""The port's sharding rules, registry and production layouts against the
JAX package's, on the CPU in one process.

A spec of the port is a plain tuple of axis names; the JAX package's is a
``PartitionSpec``: they are held entry by entry. Meshes here are
``ProcessMesh`` objects with no process groups (set_active reads only the
axis names and sizes); the groups themselves are held by the ranks of
``tests/test_torch_moe_ep.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.dist import sharding as JSH
from repro.launch import mesh as JLM

from repro_torch.dist import sharding as SH
from repro_torch.launch import mesh as LM

RULES = [
    {},
    {"pod_axis": "pod"},
    {"fsdp": True, "data_axis_size": 4},
    {"model_axis_size": 4, "moe_collectives": "dragonfly"},
    {"tensor_axis": "tp", "data_axis": "dp", "model_axis_size": 8},
]


def spec(p):
    return tuple(p)


def test_shard_rules_fields_and_defaults_are_the_references():
    jf = {f.name: f.default for f in dataclasses.fields(JSH.ShardRules)}
    tf = {f.name: f.default for f in dataclasses.fields(SH.ShardRules)}
    assert tf == jf
    assert SH.ShardRules().moe_collectives == "xla"


@pytest.mark.parametrize("kw", RULES, ids=str)
def test_specs_are_the_references(kw):
    j, t = JSH.ShardRules(**kw), SH.ShardRules(**kw)
    assert t.batch_axes == j.batch_axes
    assert t.tokens() == spec(j.tokens()) and t.activations() == spec(j.activations())
    for name in ("attn_in", "attn_out", "mlp_in", "mlp_out", "embed"):
        assert getattr(t, name)((8, 8)) == spec(getattr(j, name)((8, 8))), name
    for E in (4, 8, 16, 6):
        assert t.expert_parallel(E) == j.expert_parallel(E)
        for ff_dim in (1, 2, None):
            assert t.expert((E, 0, 0), ff_dim=ff_dim, n_experts=E) == \
                spec(j.expert((E, 0, 0), ff_dim=ff_dim, n_experts=E))
        assert t.expert((E, 0, 0)) == spec(j.expert((E, 0, 0)))
    for shape in ((16, 32), (3, 8), (0, 4)):
        for zero in (False, True):
            base = t.mlp_in(shape)
            assert t._maybe_fsdp(base, shape, zero) == \
                spec(j._maybe_fsdp(JSH.P(*base), shape, zero))


def test_make_rules_is_the_references():
    for multi_pod in (False, True):
        for fsdp in (False, True):
            t = LM.make_rules(multi_pod=multi_pod, fsdp=fsdp)
            j = JLM.make_rules(multi_pod=multi_pod, fsdp=fsdp)
            assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("shape,axes", [((2, 4), ("data", "model")),
                                        ((1, 8), ("data", "model")),
                                        ((2, 2, 2), ("pod", "data", "model"))], ids=str)
def test_set_active_rederives_the_axis_sizes(shape, axes):
    mesh = LM.ProcessMesh(axes, shape, rank=5)
    SH.set_active(SH.ShardRules(), mesh)
    try:
        rules, got = SH.active()
        assert got is mesh
        assert rules.model_axis_size == shape[-1] and rules.data_axis_size == shape[-2]
    finally:
        SH.clear_active()
    assert SH.active() is None
    # rank 5, row-major with the last axis fastest
    assert mesh.coords == dict(zip(axes, np.unravel_index(5, shape)))


def test_local_slices_cut_a_spec_like_a_partition_spec():
    """The experts of model rank m, and a dim split over (data, model)
    data-major, as PS((data, model)) gives."""
    sizes, shape = {"data": 2, "model": 4}, (8, 3, 5)
    rules = SH.ShardRules(model_axis_size=4)
    spec_ = rules.expert(shape, 2, 8)
    for m in range(4):
        sl = SH.local_slices(spec_, shape, {"data": 1, "model": m}, sizes)
        assert sl == (slice(2 * m, 2 * m + 2), slice(None), slice(None))
    for d in range(2):
        for m in range(4):
            (sl,) = SH.local_slices((("data", "model"),), (16,), {"data": d, "model": m}, sizes)
            assert (sl.start, sl.stop) == (2 * (d * 4 + m), 2 * (d * 4 + m) + 2)
    with pytest.raises(ValueError, match="does not split"):
        SH.local_slices(spec_, (6, 3, 5), {"data": 0, "model": 0}, sizes)


def test_production_mesh_and_make_mesh_need_their_world():
    with pytest.raises(ValueError, match="needs 256 ranks"):
        LM.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        LM.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="world of 8 ranks"):
        LM.make_mesh((2, 4), ("data", "model"), device="cpu")


def test_the_carrier_is_a_rule_on_the_transport():
    card = torch.device("cuda", 3)
    assert LM.carrier_device("gloo", card) == torch.device("cpu")
    assert LM.carrier_device("nccl", card) == card
    with pytest.raises(ValueError, match="no carrier rule"):
        LM.carrier_device("mpi", card)
    mesh = LM.ProcessMesh(("data", "model"), (1, 2))
    t = torch.ones(3)
    assert mesh.to_carrier(t) is t and mesh.from_carrier(t) is t
    assert (mesh.carrier_copies, mesh.carrier_bytes) == (0, 0)
    mesh.carrier = torch.device("meta")
    mesh.to_carrier(t)
    assert (mesh.carrier_copies, mesh.carrier_bytes) == (1, 12)


@pytest.mark.parametrize("cards,n,transport", [(8, 8, "nccl"), (4, 4, "nccl"), (1, 8, "gloo")])
def test_rendezvous_names_the_card_to_nccl(monkeypatch, cards, n, transport):
    """``make_dragonfly_group`` on the card: where every rank has a card of
    its own, NCCL is told the rank's card through ``device_id`` (torch
    would otherwise guess it from the rank); where ranks share a card,
    gloo gets no device. ``init_process_group`` is stubbed: no group is
    made."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: calls.append(("set", dev)))
    monkeypatch.setattr(LM.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(LM.dist, "barrier", lambda *a, **k: None)
    rank = n - 1
    LM.make_dragonfly_group(rank, n, device="cuda", init_method="file:///nonexistent")
    card = torch.device("cuda", rank % cards)
    (_, set_dev), (backend, kw) = calls
    assert set_dev == card and backend == transport
    assert (kw["rank"], kw["world_size"]) == (rank, n)
    assert kw.get("device_id") == (card if transport == "nccl" else None)


def test_rendezvous_on_the_cpu_passes_no_device(monkeypatch):
    calls = []
    monkeypatch.setattr(LM.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(LM.dist, "barrier", lambda *a, **k: None)
    LM.make_dragonfly_group(2, 8, device="cpu", init_method="file:///nonexistent")
    (backend, kw), = calls
    assert backend == "gloo" and "device_id" not in kw
