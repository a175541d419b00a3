"""The tensor-parallel MoE path (``models.moe.moe_apply_tp``) over
``torch.distributed``, against the JAX package's ``moe_apply_tp``.

Eight gloo ranks on the CPU (spawned once for the module through
``repro_torch.launch.mesh.spawn``) lay themselves out as (data, model)
meshes with ``launch.mesh.make_mesh``, register rules with
``dist.sharding.set_active`` and run every case of ``CASES``: Mixtral
smoke (4 experts) on (1, 8), where ``moe_apply_auto`` takes TP because 4
experts do not split over 8 model ranks, once with a capacity factor that
drops entries, and ``moe_apply_tp`` called directly on (2, 4) and (4, 2);
then Mixtral smoke's ``forward_train`` and ``loss_fn`` under rules (1, 8).
The JAX side runs this file as a script on 8 forced host devices, in a
subprocess started beside the ranks:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/test_torch_moe_tp.py OUT.npz PARAMS.npz

It writes the weights (``jax.random.key(0)``) to PARAMS.npz first, which
the ranks wait for. Hidden states are ``default_rng(0)`` normals × 0.1,
made by numpy on both sides.

Tolerances. Against the JAX package every output is held within
``LAYER_TOL`` (rtol = atol = 1e-5): torch's CPU ``xt @ router`` and XLA's
dot differ in the last bit at these shapes, so bit-exactness across the
packages cannot hold; the aux within float32 rounding (``AUX_TOL``, 1e-6
relative). The routes are held exactly: the same expert ids and the same
dropped (token, k) entries. Against the one-process
``moe_apply_tp_plain`` the ranks' outputs are equal bit for bit: gloo's
``all_reduce`` sums in an order of its own, not in rank order, so each
case's ranks also run ``ORDER_CALLS`` all-reduces of known data of the partials'
shape, and the oracle sums in the order read off them
(``ObservedSumOrder``); rank order gives the bits only where the model
axis has two ranks (a sum of two is the same in either order). The
forward under rules equals the one-process forward with that oracle bit
for bit. Where
nothing is dropped, the dense ``moe_apply`` is a second oracle, within
``LAYER_TOL``. The module imports no jax at its top (the JAX side and the
in-process tests import it), so the ranks, which import it, start quickly.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.dist import sharding as SH
from repro_torch.launch import mesh as LM
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models.convert import params_from_jax

from test_torch_moe_ep import SEP, assert_bits, close, flatten, unflatten, wait_for

TESTS = pathlib.Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
ARCH = "mixtral-8x7b"
LAYER_TOL = 1e-5
AUX_TOL = 1e-6
ORDER_CALLS = 32  # few ranks' float32 sums often agree across orders: read from many calls
MODEL_TOL = 1e-4

#: name -> (mesh (data, model), entry point, capacity factor or None, tokens (B, S))
CASES = {
    "mesh18": ((1, 8), "auto", None, (2, 16)),
    "drop18": ((1, 8), "auto", 0.5, (2, 64)),
    "mesh24": ((2, 4), "tp", None, (2, 16)),
    "mesh42": ((4, 2), "tp", None, (4, 16)),
}
MODEL_MESH = (1, 8)
MODEL_TOKENS = (2, 40)  # 40 tokens: the smoke config's window of 32 binds


def case_cfg(cfg, name):
    """The case's config: Mixtral smoke with its capacity factor replaced,
    the same way on both sides."""
    cf = CASES[name][2]
    if cf is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def hidden(name, d):
    B, S = CASES[name][3]
    return (np.random.default_rng(0).standard_normal((B, S, d)) * 0.1).astype(np.float32)


def model_tokens(vocab):
    return np.random.default_rng(12).integers(1, vocab, MODEL_TOKENS).astype(np.int32)


# -------------------------------------------------- the port's side: a rank
def _data_shard(a, coords, n_data):
    B = a.shape[0]
    dc = coords["data"]
    return a[dc * B // n_data:(dc + 1) * B // n_data]


def observe_order(mesh, cfg, x):
    """gloo's summation order for the all-reduce of the partial outputs of
    a data shard like ``x``, (E, C_loc, d) in x's dtype, observed on the
    model group (``ObservedSumOrder.observe``); the outputs on the group's
    first rank, None on the others."""
    B, S = x.shape[:2]
    shape = (cfg.moe.num_experts, TMOE.ep_capacity(cfg, B * S), cfg.d_model)
    out = TMOE.ObservedSumOrder.observe(mesh, "model", shape, x.dtype, calls=ORDER_CALLS)
    return [o.numpy() for o in out] if mesh.coords["model"] == 0 else None


def read_order(outputs, n_model):
    return TMOE.ObservedSumOrder.read([torch.from_numpy(o) for o in outputs], n_model, "cpu")


def run_rank(rank, group, layout, params_path):
    """Every case on this rank, and the model under rules. Returns host data."""
    with np.load(params_path) as f:
        flat = dict(f)
    base = get_smoke_config(ARCH)
    out = {"cases": {}, "model": {}}
    for name, (shape, entry, _, _) in CASES.items():
        cfg = case_cfg(base, name)
        mesh = LM.make_mesh(shape, ("data", "model"), device="cpu")
        SH.set_active(SH.ShardRules(), mesh)
        params = {k: torch.from_numpy(v) for k, v in unflatten(flat, "layer").items()}
        x = torch.from_numpy(_data_shard(hidden(name, cfg.d_model), mesh.coords, shape[0]))
        fn = TMOE.moe_apply_auto if entry == "auto" else TMOE.moe_apply_tp
        with TMOE.recording_routes() as routes:
            y, aux = fn(params, x, cfg)
        (idx, keep, _), = routes
        res = {"y": y.numpy(), "aux": aux.numpy(), "idx": idx.numpy(), "keep": keep.numpy()}
        # the expert stacks cut to this rank's ff slice beforehand
        cut = TMOE._ff_slice(params, shape[1], mesh.coords["model"])
        cut = {key: w.clone() for key, w in cut.items()}
        y_cut, aux_cut = TMOE.moe_apply_tp(cut, x, cfg)
        res["cut"] = (y_cut.numpy(), aux_cut.numpy(), cut["w_in"].shape[2])
        res["mesh"] = {"coords": mesh.coords, "transport": mesh.transport,
                       "carrier": str(mesh.carrier), "carrier_copies": mesh.carrier_copies}
        res["order"] = observe_order(mesh, cfg, x)
        out["cases"][name] = res

    cfg = get_smoke_config(ARCH)
    mesh = LM.make_mesh(MODEL_MESH, ("data", "model"), device="cpu")
    SH.set_active(SH.ShardRules(), mesh)
    tokens = torch.from_numpy(_data_shard(model_tokens(cfg.vocab), mesh.coords, MODEL_MESH[0]))
    batch = {"tokens": tokens, "labels": tokens}
    tp = params_from_jax(unflatten(flat, "model"), cfg, device="cpu",
                         rules=SH.active()[0], rank=rank)
    logits, aux, _ = TM.forward_train(tp, batch, cfg, use_kernel=False)
    loss, metrics = TM.loss_fn(tp, batch, cfg, use_kernel=False)
    out["model"] = {"logits": logits.numpy(), "aux": aux.numpy(), "loss": loss.numpy(),
                    "ce": metrics["ce"].numpy(), "ff_held": tp["stack"][0]["ffn"]["w_in"].shape[2],
                    "order": observe_order(mesh, cfg, tokens[..., None].float())}
    SH.clear_active()
    return out


# ------------------------------------ the JAX side: this file as a script
def jax_main(out: str, params_out: str) -> None:
    """The weights to ``params_out`` first, then every case through the JAX
    package's ``moe_apply_auto`` or ``moe_apply_tp`` on 8 forced host
    devices, the reference's routes per data shard, and the model under
    rules (1, 8). Saved to ``out`` (.npz)."""
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import get_smoke_config as j_smoke
    from repro.dist import sharding as JSH
    from repro.models import model as JM
    from repro.models import moe as JMOE

    assert jax.device_count() >= 8, jax.devices()
    base = j_smoke(ARCH)
    flat = {}
    p = JMOE.moe_init(jax.random.key(0), base, jnp.float32)
    flatten(jax.tree.map(np.asarray, p), "layer", flat)
    jp = JM.init_params(jax.random.key(0), base)
    flatten(jax.tree.map(np.asarray, jp), "model", flat)
    tmp = params_out + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, params_out)

    results = {}
    for name, (shape, entry, _, tokens) in CASES.items():
        cfg = case_cfg(base, name)
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape), ("data", "model"))
        x = hidden(name, cfg.d_model)
        JSH.set_active(JSH.ShardRules(), mesh)
        fn = JMOE.moe_apply_auto if entry == "auto" else JMOE.moe_apply_tp
        y, aux = fn(p, jnp.asarray(x), cfg)
        results[f"{name}{SEP}y"] = np.asarray(y)
        results[f"{name}{SEP}aux"] = np.asarray(aux)
        JSH.clear_active()
        # the reference's routes, data shard by data shard
        m = cfg.moe
        n_data = shape[0]
        T_loc = tokens[0] * tokens[1] // n_data
        C = max(8, int(m.capacity_factor * T_loc * m.top_k / m.num_experts))
        C = -(-C // 8) * 8
        xt = x.reshape(n_data, T_loc, -1)
        ids, keeps = [], []
        for s in range(n_data):
            _, idx = JMOE.router_topk(jnp.asarray(xt[s]) @ p["router"], m.top_k,
                                      m.norm_topk_probs)
            idx = np.asarray(idx)
            counts = np.zeros(m.num_experts, int)
            keep = []
            for e in idx.reshape(-1):
                keep.append(counts[e] < C)
                counts[e] += 1
            ids.append(idx)
            keeps.append(np.asarray(keep))
        results[f"{name}{SEP}idx"] = np.stack(ids)
        results[f"{name}{SEP}keep"] = np.stack(keeps)

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(MODEL_MESH), ("data", "model"))
    tokens = jnp.asarray(model_tokens(base.vocab))
    batch = {"tokens": tokens, "labels": tokens}
    JSH.set_active(JSH.ShardRules(), mesh)
    logits, aux, _ = JM.forward_train(jp, batch, base, use_kernel=False)
    loss, metrics = JM.loss_fn(jp, batch, base, use_kernel=False)
    for key, val in (("logits", logits), ("aux", aux), ("loss", loss), ("ce", metrics["ce"])):
        results[f"model{SEP}{key}"] = np.asarray(val)
    JSH.clear_active()
    np.savez(out, **results)


if __name__ == "__main__":
    jax_main(sys.argv[1], sys.argv[2])


# ------------------------------------------------------------------- tests
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(per-rank results of the port, {key: JAX result}, the weights): the
    JAX subprocess starts first and writes the weights, and the 8 gloo
    ranks run beside it once the weights are there."""
    root = tmp_path_factory.mktemp("moe_tp")
    params = root / "params.npz"
    path = os.pathsep.join([str(SRC), str(TESTS), os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=path)
    proc = subprocess.Popen([sys.executable, __file__, str(root / "ref.npz"), str(params)],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        wait_for(params, proc)
        ranks = LM.spawn(run_rank, 8, device="cpu", args=(str(params),))
    finally:
        log = proc.communicate(timeout=900)[0]
    assert proc.returncode == 0, log
    with np.load(root / "ref.npz") as f:
        ref = dict(f)
    with np.load(params) as flat:
        return ranks, ref, dict(flat)


def global_y(ranks, name, key="y"):
    """The whole (B, S, d) output: each data shard from its model group's
    first rank (every rank of a model group holds the same shard)."""
    n_data, n_model = CASES[name][0]
    rows = [ranks[dc * n_model]["cases"][name] for dc in range(n_data)]
    return np.concatenate([r[key] if key != "cut" else r["cut"][0] for r in rows])


def layer_params(flat):
    return {k: torch.from_numpy(v) for k, v in unflatten(flat, "layer").items()}


@pytest.mark.parametrize("name", list(CASES))
def test_tp_layer_matches_the_reference(runs, name):
    """Each case's output against the reference's within LAYER_TOL, the aux
    within float32 rounding, on every rank."""
    ranks, ref, _ = runs
    close(global_y(ranks, name), ref[f"{name}{SEP}y"], LAYER_TOL)
    for r in ranks:
        np.testing.assert_allclose(r["cases"][name]["aux"], ref[f"{name}{SEP}aux"],
                                   rtol=AUX_TOL, atol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_tp_routes_and_drops_are_the_reference(runs, name):
    """The same expert ids and the same dropped (token, k) entries, data
    shard by data shard, on every rank of the shard's model group; the
    drop case drops entries, the others none."""
    ranks, ref, _ = runs
    n_data, n_model = CASES[name][0]
    for r, res in enumerate(ranks):
        dc = r // n_model
        np.testing.assert_array_equal(res["cases"][name]["idx"], ref[f"{name}{SEP}idx"][dc])
        np.testing.assert_array_equal(res["cases"][name]["keep"], ref[f"{name}{SEP}keep"][dc])
    dropped = int((~ref[f"{name}{SEP}keep"]).sum())
    assert (dropped > 0) == (CASES[name][2] is not None), dropped


@pytest.mark.parametrize("name", list(CASES))
def test_tp_plain_matches_the_ranks_and_the_reference(runs, name):
    """``moe_apply_tp_plain`` in one process against the ranks, bit for bit
    when it sums the partials in the order gloo's all-reduce was observed
    to (``ObservedSumOrder``; rank order is that order only on a model
    axis of two), and against the reference within LAYER_TOL in rank
    order; the aux too."""
    ranks, ref, flat = runs
    shape = CASES[name][0]
    cfg = case_cfg(get_smoke_config(ARCH), name)
    x = torch.from_numpy(hidden(name, cfg.d_model))
    order = read_order(ranks[0]["cases"][name]["order"], shape[1])
    got = global_y(ranks, name)
    y_obs, aux_obs = TMOE.moe_apply_tp_plain(layer_params(flat), x, cfg, *shape, reduce=order)
    assert_bits(got, y_obs.numpy())
    y, aux = TMOE.moe_apply_tp_plain(layer_params(flat), x, cfg, *shape)
    if shape[1] == 2:
        assert_bits(got, y.numpy())
    close(y.numpy(), ref[f"{name}{SEP}y"], LAYER_TOL)
    np.testing.assert_allclose(aux.numpy(), ref[f"{name}{SEP}aux"], rtol=AUX_TOL, atol=0)
    assert_bits(aux_obs.numpy(), aux.numpy())


@pytest.mark.parametrize("name", [n for n, case in CASES.items() if case[2] is None])
def test_tp_matches_the_dense_layer_where_nothing_drops(runs, name):
    """At capacity factor 8 nothing is dropped, so the dense ``moe_apply``
    is a second oracle for the whole batch."""
    ranks, _, flat = runs
    cfg = get_smoke_config(ARCH)
    y, _ = TMOE.moe_apply(layer_params(flat), torch.from_numpy(hidden(name, cfg.d_model)), cfg)
    close(global_y(ranks, name), y.numpy(), LAYER_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_model_group_ranks_agree_and_cut_weights_give_the_same_bits(runs, name):
    """Every rank of a model group holds its data shard's whole output, bit
    for bit (the all-reduce gives each the same sum); expert stacks cut to
    the rank's ff slice beforehand give the bits of the whole stacks; gloo
    ranks on the CPU carry the all-reduce on the CPU with no copy."""
    ranks, _, _ = runs
    n_data, n_model = CASES[name][0]
    ff = get_smoke_config(ARCH).moe.d_ff_expert
    for r, res in enumerate(ranks):
        rec = res["cases"][name]
        assert_bits(rec["y"], ranks[r - r % n_model]["cases"][name]["y"])
        y_cut, aux_cut, held = rec["cut"]
        assert held == ff // n_model
        assert_bits(y_cut, rec["y"])
        assert_bits(aux_cut, rec["aux"])
        assert rec["mesh"]["coords"] == {"data": r // n_model, "model": r % n_model}
        assert (rec["mesh"]["transport"], rec["mesh"]["carrier"],
                rec["mesh"]["carrier_copies"]) == ("gloo", "cpu", 0)


def test_model_under_tp_rules_matches_the_reference(runs):
    """Mixtral smoke's forward and loss under rules (1, 8), where every MoE
    layer takes TP: logits, aux, loss and cross-entropy within MODEL_TOL
    on every rank; every rank holds an eighth of each expert's ff dim."""
    ranks, ref, _ = runs
    ff = get_smoke_config(ARCH).moe.d_ff_expert
    for res in ranks:
        m = res["model"]
        close(m["logits"], ref[f"model{SEP}logits"], MODEL_TOL)
        for key in ("aux", "loss", "ce"):
            close(m[key], ref[f"model{SEP}{key}"], MODEL_TOL)
        assert m["ff_held"] == ff // MODEL_MESH[1]


def test_model_under_tp_rules_is_the_one_process_forward_bit_for_bit(runs):
    """Mixtral smoke's forward under rules (1, 8) against the one-process
    forward with every MoE layer as ``moe_apply_tp_plain`` summing in
    gloo's observed order: the logits, aux and loss bit for bit on every
    rank."""
    ranks, _, flat = runs
    cfg = get_smoke_config(ARCH)
    tokens = torch.from_numpy(model_tokens(cfg.vocab))
    batch = {"tokens": tokens, "labels": tokens}
    params = params_from_jax(unflatten(flat, "model"), cfg, device="cpu")
    order = read_order(ranks[0]["model"]["order"], MODEL_MESH[1])
    auto = TMOE.moe_apply_auto
    TMOE.moe_apply_auto = lambda p, h, c: TMOE.moe_apply_tp_plain(p, h, c, *MODEL_MESH,
                                                                  reduce=order)
    try:
        logits, aux, _ = TM.forward_train(params, batch, cfg, use_kernel=False)
        loss, _ = TM.loss_fn(params, batch, cfg, use_kernel=False)
    finally:
        TMOE.moe_apply_auto = auto
    for res in ranks:
        m = res["model"]
        assert_bits(m["logits"], logits.numpy())
        assert_bits(m["aux"], aux.numpy())
        assert_bits(m["loss"], loss.numpy())


def test_observed_sum_order_refuses_what_no_ring_gives():
    """``ObservedSumOrder`` reads a ring order off observed calls and
    raises where an output is no ring sum of its inputs (a float64 sum
    rounded to float32) or the parts it sums are of another shape."""
    parts = [torch.randn(4, 32, generator=torch.Generator().manual_seed(r)) for r in range(4)]
    ring = TMOE._ring_sum(parts, 2, -1)
    order = TMOE.ObservedSumOrder([(parts, ring)])
    assert torch.equal(order(parts), ring)
    wide = torch.stack(parts).double().sum(0).float()
    with pytest.raises(ValueError, match="no ring order"):
        TMOE.ObservedSumOrder([(parts, wide)])
    with pytest.raises(ValueError, match="read at"):
        order([p[:2] for p in parts])


#: (data, model) meshes, experts and the global token count (B, S)
AUTO_CASES = [((1, 8), 4, (2, 16)), ((2, 4), 4, (2, 16)), ((4, 2), 4, (4, 16)),
              ((1, 16), 8, (1, 32)), ((16, 16), 8, (16, 8)), ((2, 3), 4, (2, 6)),
              ((2, 4), 4, (2, 3)), ((1, 4), 8, (1, 6)), ((2, 8), 8, (2, 8))]


@pytest.mark.parametrize("shape,experts,tokens", AUTO_CASES,
                         ids=[f"{s[0]}x{s[1]}-E{e}-T{t[0]}x{t[1]}" for s, e, t in AUTO_CASES])
def test_auto_takes_the_path_the_reference_takes(monkeypatch, shape, experts, tokens):
    """``moe_apply_auto`` picks EP, TP or the sparse path as the JAX
    package's does, for the same rules and tokens: the reference sees the
    whole batch, the port a rank's data shard. Each package's three paths
    are replaced by recorders, so nothing runs."""
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as j_smoke
    from repro.dist import sharding as JSH
    from repro.models import moe as JMOE

    def picks(module, calls):
        for path in ("ep", "tp", "sparse"):
            monkeypatch.setattr(module, f"moe_apply_{path}",
                                lambda *a, path=path: calls.append(path))

    def cfg_of(cfg):
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=experts))

    B, S = tokens
    j_calls, t_calls = [], []
    picks(JMOE, j_calls)
    picks(TMOE, t_calls)
    fake = types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty(shape))
    JSH.set_active(JSH.ShardRules(), fake)
    SH.set_active(SH.ShardRules(), LM.ProcessMesh(("data", "model"), shape))
    try:
        cfg = get_smoke_config(ARCH)
        JMOE.moe_apply_auto({}, jnp.zeros((B, S, cfg.d_model)), cfg_of(j_smoke(ARCH)))
        shard = max(B // shape[0], 1)
        TMOE.moe_apply_auto({}, torch.zeros(shard, S, cfg.d_model), cfg_of(cfg))
    finally:
        JSH.clear_active()
        SH.clear_active()
    assert t_calls == j_calls and len(j_calls) == 1
