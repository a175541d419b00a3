"""``train.optimizer.state_specs`` and ``train.train_step.train_shardings``
against the JAX package's, at full width, for every arch of the registry.

The port's trees are one dict a layer: layer i of the stack takes the
reference's stacked member i % period and each prefix layer the stacked
prefix member, without the leading entry, or, where FSDP shards the
stacked dim itself (``_maybe_fsdp`` picks the first spec-free dim the data
axis divides, and that is often the group dim G), with a
``dist.sharding.Holder`` naming the layer's place in it. Shapes come from
``jax.eval_shape`` on one side and the meta device on the other.

Rule variants (production axis sizes, data 16 and model 16): plain, FSDP,
ZeRO-1, multi-pod FSDP (the batch axes a tuple), the factored optimizer
under FSDP and ZeRO-1, and gradient compression (the ``err`` specs).

The held slices: this file run as a script on 512 forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=512 python
tests/test_torch_train_shardings.py OUT.json``) holds, for every leaf of
the parameters and of the optimizer state and every device of the
production meshes ((16, 16) and (2, 16, 16)), the port's
``held_slices`` against the slice of the reference's stacked leaf that
``NamedSharding.devices_indices_map`` gives that device: a layer is held
where that slice's stacked range contains it, and then the rest of the
slices are equal.
"""

import functools
import json
import os
import pathlib
import subprocess
import sys
from unittest import mock

import pytest

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.dist import sharding as SH
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS

TESTS = pathlib.Path(__file__).resolve().parent
SRC = TESTS.parent / "src"

#: name -> (ShardRules changes, OptConfig.factored, TrainSettings.compress_grads)
VARIANTS = {
    "plain": ({}, False, False),
    "fsdp": ({"fsdp": True}, False, False),
    "zero1": ({"zero1": True}, False, False),
    "multi_pod_fsdp": ({"fsdp": True, "pod_axis": "pod"}, False, False),
    "factored_fsdp": ({"fsdp": True}, True, False),
    "factored_zero1": ({"zero1": True}, True, False),
    "compress": ({}, False, True),
}
POD = 2
#: the variants whose held slices are checked (``compress`` adds ``err``,
#: whose specs are the parameters')
HELD_VARIANTS = ("plain", "fsdp", "zero1", "multi_pod_fsdp", "factored_fsdp", "factored_zero1")


def port_side(arch, variant, data=16, model=16):
    cfg = get_config(arch)
    kw, factored, compress = VARIANTS[variant]
    rules = SH.ShardRules(data_axis_size=data, model_axis_size=model, **kw)
    return cfg, rules, TS.train_shardings(cfg, rules, O.OptConfig(factored=factored),
                                          TS.TrainSettings(compress_grads=compress))


@functools.lru_cache(maxsize=None)
def ref_shapes(arch):
    """The reference's parameters as ``jax.eval_shape`` gives them."""
    import jax
    from repro.configs import get_config as j_config
    from repro.models import model as JM

    return jax.eval_shape(lambda: JM.init_params(jax.random.key(0), j_config(arch)))


def ref_side(arch, variant, data=16, model=16):
    """The reference's ``train_shardings``; its one ``jax.eval_shape`` (of
    ``init_params``, 0.7-6 s a call) answered from ``ref_shapes``, traced
    once an arch."""
    import jax
    from repro.configs import get_config as j_config
    from repro.dist import sharding as JSH
    from repro.train import optimizer as JO
    from repro.train import train_step as JTS

    kw, factored, compress = VARIANTS[variant]
    rules = JSH.ShardRules(data_axis_size=data, model_axis_size=model, **kw)
    shapes = ref_shapes(arch)
    with mock.patch.object(jax, "eval_shape", lambda fn: shapes):
        return JTS.train_shardings(j_config(arch), rules, JO.OptConfig(factored=factored),
                                   JTS.TrainSettings(compress_grads=compress))


def ref_path(path, cfg):
    """The reference's path to the leaf the port's ``path`` is a layer of,
    and whether it is stacked."""
    if path[0] == "stack":
        return ("stack", path[1] % len(cfg.layer_kinds())) + tuple(path[2:]), True
    if path[0] == "prefix":
        return ("prefix", 0) + tuple(path[2:]), True
    return tuple(path), False


def ref_get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def spec_pairs(cfg, port_specs, ref_specs, like):
    """(port path, port spec, reference stacked spec, stacked) of every
    leaf of ``like`` (a port tree of the same shape as the specs)."""
    for path, _ in O.flatten(like):
        rp, stacked = ref_path(path, cfg)
        yield path, O.get(port_specs, path), tuple(ref_get(ref_specs, rp)), stacked


def expected(path, spec, ref, stacked, cfg):
    """The reference's stacked spec as the port's per-layer spec says it."""
    if not stacked:
        return tuple(spec)
    holder, own = SH.split_holder(spec)
    G = (cfg.n_layers - cfg.first_dense_layers) // len(cfg.layer_kinds()) \
        if path[0] == "stack" else cfg.first_dense_layers
    if holder is None:
        return (None, *own)
    at = path[1] // len(cfg.layer_kinds()) if path[0] == "stack" else path[1]
    assert (holder.at, holder.of) == (at, G), (path, holder)
    return (holder.axes, *own)


def assert_specs_match(cfg, port_specs, ref_specs, like):
    n = 0
    for path, spec, ref, stacked in spec_pairs(cfg, port_specs, ref_specs, like):
        assert expected(path, spec, ref, stacked, cfg) == ref, (path, spec, ref)
        n += 1
    return n


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_shardings_match_the_reference(arch, variant):
    """Every parameter, optimizer-state and batch spec, leaf by leaf."""
    cfg, _, (pspecs, ospecs, bspecs, mspecs) = port_side(arch, variant)
    rp, ro, rb, rm = ref_side(arch, variant)
    like_p, like_s = TS.state_shapes(cfg, O.OptConfig(factored=VARIANTS[variant][1]))
    assert mspecs is None and rm is None
    assert assert_specs_match(cfg, pspecs, rp, like_p) == len(O.flatten(like_p))
    assert assert_specs_match(cfg, ospecs["mu"], ro["mu"], like_s["mu"]) == \
        len(O.flatten(like_s["mu"]))
    assert ospecs["step"] == tuple(ro["step"]) == ()
    if VARIANTS[variant][2]:
        assert_specs_match(cfg, ospecs["err"], ro["err"], like_p)
    else:
        assert "err" not in ospecs and "err" not in ro
    assert {k: tuple(v) for k, v in rb.items()} == bspecs


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_specs_factor_on_the_stacked_shape(arch):
    """``state_specs`` given the parameter specs alone mirrors them (m and
    v); given the shapes and ``factored``, the factored leaves are those the
    reference factors, with vr and vc its entries."""
    cfg, rules, _ = port_side(arch, "plain")
    from repro.configs import get_config as j_config
    from repro.dist import sharding as JSH
    from repro.models import model as JM
    from repro.train import optimizer as JO
    import jax

    pspecs = TS.M.param_specs(cfg, rules)
    jcfg = j_config(arch)
    jspecs = JM.param_specs(jcfg, JSH.ShardRules())
    shapes = ref_shapes(arch)
    for factored in (False, True):
        oc = O.OptConfig(factored=factored)
        got = O.state_specs(pspecs, oc, param_shapes=TS.param_shapes(cfg))
        want = JO.state_specs(jspecs, JO.OptConfig(factored=factored), param_shapes=shapes)
        assert_specs_match(cfg, got["mu"], want["mu"], TS.state_shapes(cfg, oc)[1]["mu"])
    plain = O.state_specs(pspecs, O.OptConfig(factored=True))
    for path, _ in O.flatten(TS.param_shapes(cfg)):
        assert O.get(plain["mu"], path) == {"m": O.get(pspecs, path), "v": O.get(pspecs, path)}


def holders(arch, data, model=16):
    cfg, rules, (pspecs, _, _, _) = port_side(arch, "fsdp", data=data, model=model)
    sizes = {"data": data, "model": model}
    return cfg, pspecs, sizes


def test_trap_olmo_one_layer_a_data_rank():
    """OLMo-1B at data 16: 16 layers of period 1, so FSDP puts G = 16 over
    the data axis, one whole layer on each data coordinate."""
    cfg, pspecs, sizes = holders("olmo-1b", 16)
    assert len(pspecs["stack"]) == 16
    for i, layer in enumerate(pspecs["stack"]):
        wq = layer["mixer"]["wq"]
        assert wq == (SH.Holder("data", i, 16), None, "model")
        held = [d for d in range(16) if SH.held_slices(wq, (2048, 2048), {"data": d, "model": 0},
                                                       sizes) is not None]
        assert held == [i]


def test_trap_tinyllama_g22_at_data_2():
    """TinyLlama-1.1B at data 2: G = 22, 11 whole layers a data coordinate,
    a norm scale included (not its d dim)."""
    cfg, pspecs, sizes = holders("tinyllama-1.1b", 2, model=2)
    for i, layer in enumerate(pspecs["stack"]):
        assert layer["mixer"]["wq"] == (SH.Holder("data", i, 22), None, "model")
        assert layer["norm1"]["scale"] == (SH.Holder("data", i, 22), None)
        assert SH.Holder("data", i, 22).index(sizes) == i // 11
    # the embedding table splits by vocab over data, the unembedding by d
    assert pspecs["embed"]["table"] == ("data", "model")
    assert pspecs["unembed"]["w"] == ("data", "model")


def test_trap_mixtral_experts_held_whole_at_data_2():
    """Mixtral-8x7B at data 2 (G = 32): every leaf of the stack, the
    expert stacks included, lies whole on one data coordinate."""
    _, pspecs, _ = holders("mixtral-8x7b", 2, model=2)
    for i, layer in enumerate(pspecs["stack"]):
        assert layer["ffn"]["w_in"] == (SH.Holder("data", i, 32), "model", None, None)
        assert layer["ffn"]["router"] == (SH.Holder("data", i, 32), None, None)


def test_trap_falls_to_a_later_dim():
    """Jamba-1.5-Large at data 16: G = 9, which 16 does not divide, so FSDP
    falls to the leaf's own first free dim; DeepSeek-V3's prefix (3
    layers) likewise."""
    _, pspecs, _ = holders("jamba-1.5-large-398b", 16)
    attn = next(layer for layer in pspecs["stack"] if "wq" in layer["mixer"])
    assert attn["norm1"]["scale"] == ("data",)
    assert attn["mixer"]["wq"] == ("data", "model")
    _, pspecs, _ = holders("deepseek-v3-671b", 16)
    assert pspecs["prefix"][0]["norm1"]["scale"] == ("data",)


def test_multi_pod_holder_is_row_major_over_the_batch_axes():
    """With a pod axis the batch axes are (pod, data): a stacked dim of 32
    groups over 2·16 coordinates puts group g on pod g // 16, data g % 16."""
    h = SH.Holder(("pod", "data"), 21, 32)
    sizes = {"pod": 2, "data": 16, "model": 16}
    assert h.index(sizes) == 21
    assert h.holds({"pod": 1, "data": 5, "model": 3}, sizes)
    assert not h.holds({"pod": 0, "data": 5, "model": 3}, sizes)
    with pytest.raises(ValueError):
        SH.local_slices((h, None), (4,), {"pod": 1, "data": 5}, sizes)


# ------------------------------------------- the held slices: a script
def _bounds(slices, shape):
    return [s.indices(n)[:2] for s, n in zip(slices, shape)]


def check_held(out_path):
    """Every leaf, every device: the port's ``held_slices`` against
    ``NamedSharding.devices_indices_map`` of the reference's stacked leaf.
    A stacked leaf the reference cannot place (``NamedSharding`` raises)
    must raise in the port too. Writes {arch/variant: [leaves checked,
    devices checked, mismatches, leaves neither places]}."""
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding
    from repro.configs import get_config as j_config
    from repro.models import model as JM
    from repro.train import optimizer as JO

    devices = np.array(jax.devices()[:POD * 256])
    meshes = {False: Mesh(devices[:256].reshape(16, 16), ("data", "model")),
              True: Mesh(devices.reshape(POD, 16, 16), ("pod", "data", "model"))}
    report = {}
    for arch in ARCH_IDS:
        jcfg = j_config(arch)
        for variant in HELD_VARIANTS:
            cfg, rules, (pspecs, ospecs, _, _) = port_side(arch, variant)
            rp, ro, _, _ = ref_side(arch, variant)
            factored = VARIANTS[variant][1]
            mesh = meshes[rules.pod_axis is not None]
            sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
            coords = [dict(zip(mesh.axis_names, ix)) for ix in np.ndindex(mesh.devices.shape)]
            flat_dev = list(mesh.devices.flat)
            jp = ref_shapes(arch)
            js = jax.eval_shape(lambda: JO.init_state(jp, JO.OptConfig(factored=factored)))
            like_p, like_s = TS.state_shapes(cfg, O.OptConfig(factored=factored))
            leaves, bad, unplaced, cache, seen = 0, 0, 0, {}, {}
            for trees in ((pspecs, rp, like_p, jp), (ospecs["mu"], ro["mu"], like_s["mu"],
                                                    js["mu"])):
                port_specs, ref_specs, like, ref_sds = trees
                for path, leaf in O.flatten(like):
                    rpath, stacked = ref_path(path, cfg)
                    ref_shape = tuple(ref_get(ref_sds, rpath).shape)
                    ref_spec = ref_get(ref_specs, rpath)
                    key = (rpath, ref_spec, ref_shape)
                    if key not in cache:
                        try:
                            imap = NamedSharding(mesh, ref_spec).devices_indices_map(ref_shape)
                            cache[key] = [imap[d] for d in flat_dev]
                        except ValueError:  # the reference cannot place it (ROADMAP Queue 3)
                            cache[key] = None
                    spec, shape = O.get(port_specs, path), tuple(leaf.shape)
                    at = (path[1] // len(cfg.layer_kinds()) if path[0] == "stack" else
                          path[1]) if stacked else None
                    leaves += 1
                    if cache[key] is None:
                        unplaced += 1
                        try:
                            SH.held_slices(spec, shape, coords[0], sizes)
                            bad += 1  # the port places what the reference cannot
                        except ValueError:
                            pass
                        continue
                    holder, own = SH.split_holder(spec)
                    memo = (key, own, shape)
                    if memo not in seen:  # the leaf's own dims: the same for every layer
                        seen[memo] = sum(
                            _bounds(SH.local_slices(own, shape, c, sizes), shape) !=
                            _bounds(idx[1:] if stacked else idx, shape)
                            for c, idx in zip(coords, cache[key]))
                    bad += seen[memo]
                    if stacked:  # which devices hold this layer (a spec without a Holder: all)
                        memo = (key, spec, shape, at if holder is not None else None)
                        if memo not in seen:
                            lo_hi = [idx[0].indices(ref_shape[0])[:2] for idx in cache[key]]
                            seen[memo] = sum(
                                (SH.held_slices(spec, shape, c, sizes) is not None) !=
                                (lo <= at < hi) for c, (lo, hi) in zip(coords, lo_hi))
                        bad += seen[memo]
            report[f"{arch}/{variant}"] = [leaves, len(coords), bad, unplaced]
    pathlib.Path(out_path).write_text(json.dumps(report))


if __name__ == "__main__":
    check_held(sys.argv[1])


@pytest.fixture(scope="module")
def held_report(tmp_path_factory):
    out = tmp_path_factory.mktemp("held") / "report.json"
    path = os.pathsep.join([str(SRC), str(TESTS), os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={POD * 256}",
               JAX_PLATFORMS="cpu", PYTHONPATH=path)
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_held_slices_are_the_named_sharding(held_report, arch):
    """Every leaf of the parameters and the optimizer state, every device
    of the production mesh (and of the multi-pod one): the same slices, or
    nothing where the reference's stacked slice leaves the layer out."""
    for variant in HELD_VARIANTS:
        leaves, devices, bad, unplaced = held_report[f"{arch}/{variant}"]
        assert leaves > 0 and devices == (POD * 256 if "pod" in variant else 256)
        assert bad == 0, (arch, variant, bad)
        # multi-pod FSDP: _maybe_fsdp asks that the data axis divide a dim, then
        # splits it over pod·data (ROADMAP Queue 3); nowhere else
        assert unplaced == 0 or variant == "multi_pod_fsdp", (arch, variant, unplaced)
