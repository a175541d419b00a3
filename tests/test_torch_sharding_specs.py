"""The port's sharding spec trees (``models.param_specs``,
``models.cache_specs``) against the JAX package's, for every arch of the
registry at full width.

The port keeps one dict a layer where the JAX package stacks each member
of the stack over its layer groups and the dense prefix over its layers,
so layer i of the port's stack takes member i % period of the reference's
``stack_specs`` without its leading (group) entry, each prefix layer the
reference's one stacked prefix member likewise, and each prefix layer's
cache the reference's ``stack_cache_specs(...)[0]``, as its
``cache_specs`` gives the prefix. Every other leaf (embedding, final norm,
unembedding, the MTP head) is the reference's ``tuple(P)``.

Shapes come from the port's ``init_params`` and ``init_cache`` on the
meta device, so nothing at full width is allocated: every sharded dim
divides 16, the size of both axes of the production mesh, as
``tests/test_sharding_rules.py`` checks on the reference's shapes. The
trees' structure matches the parameters and caches of every smoke config
on the CPU. ``models.moe.local_experts``, which cuts the expert stacks
through ``moe_specs``, gives the views of ``rules.expert`` called on each
stack directly, on every mesh the EP and TP paths run on.
"""

import dataclasses

import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as j_config
from repro.dist.sharding import ShardRules as JRules
from repro.models import model as JM

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.dist import sharding as SH
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

AXIS = 16  # both axes of the production mesh (data 16, model 16)
CACHE_SHAPE = (16, 128)  # (batch, max_seq) of the cache trees held to the axis sizes


def ref_tree(node):
    """The reference's spec tree as plain tuples, lists for tuples of trees."""
    if isinstance(node, P):
        return tuple(node)
    if isinstance(node, dict):
        return {key: ref_tree(val) for key, val in node.items()}
    return [ref_tree(val) for val in node]


def unstack(member_tree):
    """A stacked member's spec tree without the leading (layer) entry."""
    if isinstance(member_tree, dict):
        return {key: unstack(val) for key, val in member_tree.items()}
    assert member_tree[0] is None, member_tree
    return member_tree[1:]


def per_layer(ref, cfg):
    """The reference's param or cache spec tree in the port's layout."""
    out = dict(ref)
    members = ref["stack"]
    out["stack"] = [unstack(members[i % len(members)])
                    for i in range(cfg.n_layers - cfg.first_dense_layers)]
    if "prefix" in ref:
        (prefix,) = ref["prefix"]
        out["prefix"] = [unstack(prefix) for _ in range(cfg.first_dense_layers)]
    return out


def leaves(specs, tree, path=""):
    """(path, spec, tensor) of every leaf, asserting that the two trees have
    the same structure: the same keys, the same list lengths."""
    if isinstance(tree, dict):
        assert isinstance(specs, dict) and specs.keys() == tree.keys(), (path, specs, tree.keys())
        for key in tree:
            yield from leaves(specs[key], tree[key], f"{path}/{key}")
    elif isinstance(tree, list):
        assert isinstance(specs, list) and len(specs) == len(tree), path
        for i, (s, t) in enumerate(zip(specs, tree)):
            yield from leaves(s, t, f"{path}/{i}")
    else:
        assert isinstance(specs, tuple) and len(specs) <= tree.ndim, (path, specs, tree.shape)
        yield path, specs, tree


def meta_params(cfg):
    return TM.init_params(torch.Generator(), cfg, device="meta")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_are_the_references(arch):
    got = TM.param_specs(get_config(arch), SH.ShardRules())
    want = per_layer(ref_tree(JM.param_specs(j_config(arch), JRules())), get_config(arch))
    assert got == want


@pytest.mark.parametrize("long_context", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_are_the_references(arch, long_context):
    got = TM.cache_specs(get_config(arch), SH.ShardRules(), long_context)
    ref = ref_tree(JM.cache_specs(j_config(arch), JRules(), long_context))
    assert got == per_layer(ref, get_config(arch))
    if get_config(arch).first_dense_layers:  # the stack's first member, as the reference's
        assert got["prefix"][0] == unstack(ref["stack"][0])


def check_divides(specs, tree):
    for path, spec, t in leaves(specs, tree):
        for dim, ax in zip(t.shape, spec):
            if ax is not None:
                assert dim % AXIS == 0, (path, tuple(t.shape), spec)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_width_sharded_dims_divide_the_axes(arch):
    """The spec trees have the full config's parameter and cache trees'
    structure (made on the meta device), and every sharded dim of them
    splits over a 16-wide axis."""
    cfg = get_config(arch)
    check_divides(TM.param_specs(cfg, SH.ShardRules()), meta_params(cfg))
    check_divides(TM.cache_specs(cfg, SH.ShardRules(), False),
                  TM.init_cache(cfg, *CACHE_SHAPE, device="meta"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_spec_trees_match_the_trees(arch):
    """Every leaf of the smoke config's parameters and cache on the CPU has
    a spec, and every spec a leaf, with no more entries than dims."""
    cfg = get_smoke_config(arch)
    params = TM.init_params(0, cfg, device="cpu")
    assert list(leaves(TM.param_specs(cfg, SH.ShardRules()), params))
    assert list(leaves(TM.cache_specs(cfg, SH.ShardRules(), False),
                       TM.init_cache(cfg, 2, 16, device="cpu")))


def rules_expert_views(params, rules, coords, sizes):
    """The expert stacks cut by ``rules.expert`` called on each directly."""
    E = params["router"].shape[1]
    return {key: w[SH.local_slices(rules.expert(w.shape, TMOE.EXPERT_FF_DIM[key], E), w.shape,
                                   coords, sizes)] for key, w in params.items()
            if key in TMOE.EXPERT_FF_DIM}


def smoke_moe(arch, experts):
    cfg = get_smoke_config(arch)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=experts))


#: (label, config, mesh (data, model)): the CPU EP and TP tests' cases and
#: the chip's full-width meshes
VIEW_CASES = [
    ("mixtral smoke, 4 experts, (2, 4)", lambda: smoke_moe("mixtral-8x7b", 4), (2, 4)),
    ("mixtral smoke, 8 experts, (1, 8)", lambda: smoke_moe("mixtral-8x7b", 8), (1, 8)),
    ("mixtral smoke, 4 experts, (1, 8) TP", lambda: smoke_moe("mixtral-8x7b", 4), (1, 8)),
    ("mixtral smoke, 4 experts, (4, 2)", lambda: smoke_moe("mixtral-8x7b", 4), (4, 2)),
    ("deepseek smoke, (2, 4)", lambda: get_smoke_config("deepseek-v3-671b"), (2, 4)),
    ("deepseek smoke, (4, 2)", lambda: get_smoke_config("deepseek-v3-671b"), (4, 2)),
    ("deepseek smoke, (1, 8) TP", lambda: get_smoke_config("deepseek-v3-671b"), (1, 8)),
    ("mixtral full, (1, 8)", lambda: get_config("mixtral-8x7b"), (1, 8)),
    ("mixtral full, (1, 16) TP", lambda: get_config("mixtral-8x7b"), (1, 16)),
    ("deepseek full, (1, 16)", lambda: get_config("deepseek-v3-671b"), (1, 16)),
]


@pytest.mark.parametrize("label,make,mesh", VIEW_CASES, ids=[c[0] for c in VIEW_CASES])
def test_local_experts_gives_the_same_views(label, make, mesh):
    """On every rank of the mesh: the same shapes, strides and storage
    offsets as ``rules.expert``'s cut, views of the whole stacks, and the
    router and shared expert untouched. Full configs on the meta device."""
    cfg = make()
    full = cfg.d_model > 1024
    gen = torch.Generator().manual_seed(0)
    ffn = TMOE.moe_init(gen, cfg, torch.float32, "meta" if full else "cpu")
    n_data, n_model = mesh
    rules = SH.ShardRules(model_axis_size=n_model, data_axis_size=n_data)
    sizes = {"data": n_data, "model": n_model}
    for rank in range(n_data * n_model):
        coords = {"data": rank // n_model, "model": rank % n_model}
        got = TMOE.local_experts(ffn, cfg, rules, coords, sizes)
        want = rules_expert_views(ffn, rules, coords, sizes)
        assert got.keys() == ffn.keys()
        for key, w in want.items():
            g = got[key]
            assert (g.shape, g.stride(), g.storage_offset()) == (
                w.shape, w.stride(), w.storage_offset()), (label, rank, key)
            if not full:
                assert g.untyped_storage().data_ptr() == ffn[key].untyped_storage().data_ptr()
                assert torch.equal(g, w)
        for key in ffn.keys() - want.keys():
            assert got[key] is ffn[key]
