"""DeepSeek-V3 (smoke: 4 experts top-2, 1 shared expert, MLA, 1 dense-prefix
layer, the MTP head) through the port's expert-parallel and
tensor-parallel MoE, against the JAX package.

Eight gloo ranks on the CPU (spawned once for the module through
``repro_torch.launch.mesh.spawn``) run every case of ``CASES``:
``moe_apply_ep`` at (2, 4) (one expert a rank) and at (4, 2) (two: the
``E_loc > 1`` layout of the dispatch buffers), each in all four modes, a
drop case at capacity factor 0.5 (the smoke config's 8.0 drops nothing),
and ``moe_apply_auto`` at (1, 8), where 4 experts do not split over 8 model
ranks and it takes ``moe_apply_tp``; then the whole smoke model's
``forward_train`` and ``loss_fn`` under rules (2, 4) (MLA, the dense
prefix, two MoE layers, the MTP head) in the ``xla`` and fused modes, on
each rank's compute leaves (``models.local_params``: MLA, the dense MLPs,
the shared expert, the embedding and the unembedding tensor-parallel, the
logits gathered over the vocabulary). The shared expert runs in every
case, on each rank's data shard after the exchange or the all-reduce. The JAX side runs this file as a script on 8
forced host devices, in two subprocesses started beside the ranks:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/test_torch_moe_deepseek.py OUT.npz PARAMS.npz PART...

One writes the weights (``jax.random.key(0)``) to PARAMS.npz first, which
the ranks wait for. Hidden states are ``default_rng(0)`` normals × 0.1,
made by numpy on both sides.

Tolerances are those of ``tests/test_torch_moe_ep.py``: every output
within ``LAYER_TOL`` of the reference (torch's CPU ``xt @ router`` and
XLA's dot differ in the last bit), the model within ``MODEL_TOL``; routes
and drops exact; the port's ``xla``, ``dragonfly`` and
``dragonfly_overlap`` bit-identical to each other; ``moe_apply_ep_plain``
the bits of the ranks' ``xla`` mode (in the model, the same ranks' forward
with it in every MoE layer), and ``moe_apply_tp_plain`` the bits of
the TP ranks when it sums in gloo's observed order (``ObservedSumOrder``).
The module imports no jax at its top, so the ranks, which import it,
start quickly.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

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
ARCH = "deepseek-v3-671b"
LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
ORDER_CALLS = 32  # as tests/test_torch_moe_tp.py: all-reduces gloo's order is read off
MODES = ("xla", "dragonfly", "dragonfly_overlap", "dragonfly_overlap_fused")
EXCHANGE_ONLY = MODES[:3]
FUSED = MODES[3]

#: name -> (mesh (data, model), entry point, capacity factor or None,
#: tokens (B, S), the modes the JAX side runs)
CASES = {
    "ep24": ((2, 4), "ep", None, (2, 16), MODES),
    "ep42": ((4, 2), "ep", None, (4, 16), ("xla", FUSED)),
    "drop": ((2, 4), "ep", 0.5, (2, 64), ("xla", FUSED)),
    "tp18": ((1, 8), "auto", None, (2, 16), ("auto",)),
}
EP_CASES = [name for name, case in CASES.items() if case[1] == "ep"]
MODEL_MESH = (2, 4)
MODEL_MODES = ("xla", FUSED)
MODEL_TOKENS = (2, 40)
#: the JAX side's two subprocesses: (writes the weights, the parts it runs)
JAX_PARTS = ((False, ("ep24",)), (True, ("ep42", "drop", "tp18", "model")))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for torch while the module runs (the ranks set
    their own), as the training test files run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def case_cfg(cfg, name):
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
def to_torch(tree):
    if isinstance(tree, dict):
        return {key: to_torch(val) for key, val in tree.items()}
    return torch.from_numpy(tree)


def _data_shard(a, coords, n_data):
    B = a.shape[0]
    dc = coords["data"]
    return a[dc * B // n_data:(dc + 1) * B // n_data]


def run_rank(rank, group, layout, params_path):
    """Every case on this rank, and the model under rules. Returns host data."""
    with np.load(params_path) as f:
        flat = dict(f)
    base = get_smoke_config(ARCH)
    out = {"cases": {}, "model": {}}
    for name, (shape, entry, _, _, _) in CASES.items():
        cfg = case_cfg(base, name)
        mesh = LM.make_mesh(shape, ("data", "model"), device="cpu")
        params = to_torch(unflatten(flat, "layer"))
        x = torch.from_numpy(_data_shard(hidden(name, cfg.d_model), mesh.coords, shape[0]))
        res = {}
        for mode in MODES if entry == "ep" else ("auto",):
            SH.set_active(SH.ShardRules(moe_collectives="xla" if mode == "auto" else mode), mesh)
            fn = TMOE.moe_apply_ep if entry == "ep" else TMOE.moe_apply_auto
            with TMOE.recording_routes() as routes:
                y, aux = fn(params, x, cfg)
            (idx, keep, _), = routes
            res[mode] = (y.numpy(), aux.numpy(), idx.numpy(), keep.numpy())
        rules = SH.active()[0]
        if entry == "ep":
            # the expert stacks cut to this rank's by moe_specs, through moe_apply_auto
            cut = {k: w.clone() if k in TMOE.EXPERT_FF_DIM else w for k, w in
                   TMOE.local_experts(params, cfg, rules, mesh.coords, mesh.sizes).items()}
            y, aux = TMOE.moe_apply_auto(cut, x, cfg)
            res["cut-auto"] = (y.numpy(), aux.numpy(), cut["w_in"].shape[0])
        else:
            B, S = x.shape[:2]
            order_shape = (cfg.moe.num_experts, TMOE.ep_capacity(cfg, B * S), cfg.d_model)
            order = TMOE.ObservedSumOrder.observe(mesh, "model", order_shape, x.dtype,
                                                  calls=ORDER_CALLS)
            res["order"] = [o.numpy() for o in order] if mesh.coords["model"] == 0 else None
            res["ff_held"] = TMOE.local_experts(params, cfg, rules, mesh.coords,
                                                mesh.sizes)["w_in"].shape[2]
        out["cases"][name] = res

    cfg = base
    mesh = LM.make_mesh(MODEL_MESH, ("data", "model"), device="cpu")
    tokens = torch.from_numpy(_data_shard(model_tokens(cfg.vocab), mesh.coords, MODEL_MESH[0]))
    batch = {"tokens": tokens, "labels": tokens}
    whole = params_from_jax(unflatten(flat, "model"), cfg, device="cpu")
    for mode in MODEL_MODES:
        SH.set_active(SH.ShardRules(moe_collectives=mode), mesh)
        tp = TM.local_params(whole, cfg, SH.active()[0], mesh.coords, mesh.sizes)
        with TMOE.recording_routes() as routes:
            logits, aux, _ = TM.forward_train(tp, batch, cfg, use_kernel=False)
        loss, metrics = TM.loss_fn(tp, batch, cfg, use_kernel=False)
        out["model"][mode] = {
            "logits": TM.whole_logits(logits).numpy(), "aux": aux.numpy(),
            **{key: val.numpy() for key, val in metrics.items()},
            "routes": [(i.numpy(), k.numpy()) for i, k, _ in routes],
            "experts_held": [layer["ffn"]["w_in"].shape[0] for layer in tp["stack"]],
            "shared_held": tp["stack"][0]["ffn"]["shared"]["w_in"].shape}
        if mode == "xla":
            out["model"]["oracle"] = oracle_forward(whole, tp, batch, cfg)
    SH.clear_active()
    return out


def oracle_forward(whole, tp, batch, cfg):
    """The same rank's forward with every MoE layer as
    ``moe_apply_ep_plain`` over its data shard's model group (n_data 1) on
    the whole experts, the dense layers tensor-parallel as in the ranks'
    own forward: the logits and each MoE layer's routes and drops."""
    tree = {**tp, "stack": [dict(layer, ffn={**layer["ffn"], **{
        k: w for k, w in full["ffn"].items() if k in TMOE.EXPERT_FF_DIM}})
        for layer, full in zip(tp["stack"], whole["stack"])]}
    auto = TMOE.moe_apply_auto
    TMOE.moe_apply_auto = lambda p, h, c: TMOE.moe_apply_ep_plain(p, h, c, 1, MODEL_MESH[1])
    try:
        with TMOE.recording_routes() as routes:
            logits = TM.forward_train(tree, {"tokens": batch["tokens"]}, cfg,
                                      use_kernel=False)[0]
    finally:
        TMOE.moe_apply_auto = auto
    return {"logits": TM.whole_logits(logits).numpy(),
            "routes": [(i.numpy(), k.numpy()) for i, k, _ in routes]}


# ------------------------------------ the JAX side: this file as a script
def ref_routes(JMOE, jnp, p, x, cfg, shards):
    """The reference's top-k ids and kept entries, token shard by shard, at
    the EP/TP capacity of one shard."""
    m = cfg.moe
    T_loc = x.shape[0] * x.shape[1] // shards
    C = max(8, int(m.capacity_factor * T_loc * m.top_k / m.num_experts))
    C = -(-C // 8) * 8
    ids, keeps = [], []
    for xs in x.reshape(shards, T_loc, -1):
        _, idx = JMOE.router_topk(jnp.asarray(xs) @ p["router"], m.top_k, m.norm_topk_probs)
        idx = np.asarray(idx)
        counts = np.zeros(m.num_experts, int)
        keep = []
        for e in idx.reshape(-1):
            keep.append(counts[e] < C)
            counts[e] += 1
        ids.append(idx)
        keeps.append(np.asarray(keep))
    return np.stack(ids), np.stack(keeps)


def jax_main(out: str, params_out: str, parts) -> None:
    """The weights to ``params_out`` first (unless it is "-"), then the
    ``parts`` (case names and "model") through the JAX package on 8 forced
    host devices. Saved to ``out`` (.npz)."""
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
    p = JMOE.moe_init(jax.random.key(0), base, jnp.float32)
    jp = JM.init_params(jax.random.key(0), base)
    if params_out != "-":
        flat = {}
        flatten(jax.tree.map(np.asarray, p), "layer", flat)
        flatten(jax.tree.map(np.asarray, jp), "model", flat)
        tmp = params_out + ".tmp.npz"
        np.savez(tmp, **flat)
        os.replace(tmp, params_out)

    results = {}
    for name, (shape, entry, _, _, jax_modes) in CASES.items():
        if name not in parts:
            continue
        cfg = case_cfg(base, name)
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape), ("data", "model"))
        x = hidden(name, cfg.d_model)
        for mode in jax_modes:
            JSH.set_active(JSH.ShardRules(moe_collectives="xla" if mode == "auto" else mode),
                           mesh)
            fn = JMOE.moe_apply_ep if entry == "ep" else JMOE.moe_apply_auto
            y, aux = fn(p, jnp.asarray(x), cfg)
            results[f"{name}{SEP}{mode}{SEP}y"] = np.asarray(y)
            results[f"{name}{SEP}{mode}{SEP}aux"] = np.asarray(aux)
        JSH.clear_active()
        shards = shape[0] * shape[1] if entry == "ep" else shape[0]
        results[f"{name}{SEP}idx"], results[f"{name}{SEP}keep"] = ref_routes(
            JMOE, jnp, p, x, cfg, shards)

    if "model" in parts:
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(MODEL_MESH), ("data", "model"))
        tokens = jnp.asarray(model_tokens(base.vocab))
        batch = {"tokens": tokens, "labels": tokens}
        for mode in MODEL_MODES:
            JSH.set_active(JSH.ShardRules(moe_collectives=mode), mesh)
            logits, aux, _ = JM.forward_train(jp, batch, base, use_kernel=False)
            _, metrics = JM.loss_fn(jp, batch, base, use_kernel=False)
            for key, val in (("logits", logits), ("aux", aux), *metrics.items()):
                results[f"model{SEP}{mode}{SEP}{key}"] = np.asarray(val)
        JSH.clear_active()
    np.savez(out, **results)


if __name__ == "__main__":
    jax_main(sys.argv[1], sys.argv[2], sys.argv[3:])


# ------------------------------------------------------------------- tests
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(per-rank results of the port, {key: JAX result}, the weights)."""
    root = tmp_path_factory.mktemp("moe_deepseek")
    params = root / "params.npz"
    path = os.pathsep.join([str(SRC), str(TESTS), os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=path)
    procs = [subprocess.Popen([sys.executable, __file__, str(root / f"ref{i}.npz"),
                               str(params) if writes else "-", *parts],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for i, (writes, parts) in enumerate(JAX_PARTS)]
    try:
        wait_for(params, procs[[w for w, _ in JAX_PARTS].index(True)])
        ranks = LM.spawn(run_rank, 8, device="cpu", args=(str(params),))
    finally:
        logs = [proc.communicate(timeout=900)[0] for proc in procs]
    ref = {}
    for i, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, log
        with np.load(root / f"ref{i}.npz") as part:
            ref.update(part)
    with np.load(params) as flat:
        return ranks, ref, dict(flat)


def global_y(ranks, name, mode):
    """The whole (B, S, d) output: each data shard from its model group's
    first rank."""
    n_data, n_model = CASES[name][0]
    return np.concatenate([ranks[dc * n_model]["cases"][name][mode][0] for dc in range(n_data)])


def layer_params(flat):
    return to_torch(unflatten(flat, "layer"))


def ref_mode(name, mode):
    """The reference's mode a port mode is held to: the same where it ran,
    else ``xla`` (its exchange-only modes are bit-identical)."""
    return mode if mode in CASES[name][4] else "xla"


@pytest.mark.parametrize("name,mode", [(n, m) for n in EP_CASES for m in MODES] +
                         [("tp18", "auto")])
def test_layer_matches_the_reference(runs, name, mode):
    """Each case and mode against the reference within LAYER_TOL, the aux
    too, on every rank; every rank of a model group holds its data shard's
    whole output, bit for bit."""
    ranks, ref, _ = runs
    want = ref_mode(name, mode)
    close(global_y(ranks, name, mode), ref[f"{name}{SEP}{want}{SEP}y"], LAYER_TOL)
    n_model = CASES[name][0][1]
    for r, res in enumerate(ranks):
        close(res["cases"][name][mode][1], ref[f"{name}{SEP}{want}{SEP}aux"], LAYER_TOL)
        assert_bits(res["cases"][name][mode][0], ranks[r - r % n_model]["cases"][name][mode][0])


def test_reference_exchange_modes_are_bit_identical(runs):
    """The premise of holding the port's dragonfly modes to the reference's
    ``xla`` where only that ran."""
    _, ref, _ = runs
    for mode in EXCHANGE_ONLY[1:]:
        assert_bits(ref[f"ep24{SEP}{mode}{SEP}y"], ref[f"ep24{SEP}xla{SEP}y"])


@pytest.mark.parametrize("name", EP_CASES)
def test_port_exchange_modes_are_bit_identical(runs, name):
    """xla, dragonfly and dragonfly_overlap differ only in transport: the
    same bits on every rank; the fused mode within LAYER_TOL; the aux the
    same in all four and on every rank."""
    ranks, _, _ = runs
    for res in ranks:
        r = res["cases"][name]
        for mode in EXCHANGE_ONLY[1:]:
            assert_bits(r[mode][0], r["xla"][0])
        close(r[FUSED][0], r["xla"][0], LAYER_TOL)
        for mode in MODES[1:]:
            assert_bits(r[mode][1], r["xla"][1])
        assert r["xla"][1] == ranks[0]["cases"][name]["xla"][1]


@pytest.mark.parametrize("name", list(CASES))
def test_routes_and_drops_are_the_references(runs, name):
    """The same expert ids and dropped (token, k) entries, shard by shard
    (EP: rank r routes token shard r; TP: every rank of a model group its
    data shard); only the drop case drops."""
    ranks, ref, _ = runs
    n_data, n_model = CASES[name][0]
    modes = MODES if CASES[name][1] == "ep" else ("auto",)
    for mode in modes:
        if CASES[name][1] == "ep":
            idx = np.stack([res["cases"][name][mode][2] for res in ranks])
            keep = np.stack([res["cases"][name][mode][3] for res in ranks])
        else:
            idx = np.stack([ranks[dc * n_model]["cases"][name][mode][2] for dc in range(n_data)])
            keep = np.stack([ranks[dc * n_model]["cases"][name][mode][3] for dc in range(n_data)])
        np.testing.assert_array_equal(idx, ref[f"{name}{SEP}idx"])
        np.testing.assert_array_equal(keep, ref[f"{name}{SEP}keep"])
    assert (int((~keep).sum()) > 0) == (name == "drop")


@pytest.mark.parametrize("name", EP_CASES)
def test_ep_plain_matches_the_ranks_and_the_reference(runs, name):
    """``moe_apply_ep_plain`` in one process: the bits of the ranks' ``xla``
    mode (the same routes, each model coordinate's experts as one batch,
    the same combine, the shared expert), within LAYER_TOL of the
    reference; the aux too."""
    ranks, ref, flat = runs
    cfg = case_cfg(get_smoke_config(ARCH), name)
    x = torch.from_numpy(hidden(name, cfg.d_model))
    y, aux = TMOE.moe_apply_ep_plain(layer_params(flat), x, cfg, *CASES[name][0])
    assert_bits(y.numpy(), global_y(ranks, name, "xla"))
    close(y.numpy(), ref[f"{name}{SEP}xla{SEP}y"], LAYER_TOL)
    close(aux.numpy(), ref[f"{name}{SEP}xla{SEP}aux"], LAYER_TOL)
    close(aux.numpy(), ranks[0]["cases"][name]["xla"][1], LAYER_TOL)


@pytest.mark.parametrize("name", EP_CASES)
def test_cut_experts_through_auto_take_the_same_path(runs, name):
    """Expert stacks cut to the rank's E/n_model by ``moe_specs`` give the
    bits of the whole stacks, and ``moe_apply_auto`` takes EP."""
    ranks, _, _ = runs
    n_model = CASES[name][0][1]
    for res in ranks:
        y, aux, held = res["cases"][name]["cut-auto"]
        assert held == get_smoke_config(ARCH).moe.num_experts // n_model
        assert_bits(y, res["cases"][name]["xla"][0])
        assert_bits(aux, res["cases"][name]["xla"][1])


def test_tp_plain_matches_the_ranks(runs):
    """At (1, 8) ``moe_apply_auto`` took TP (each rank an eighth of every
    expert's ff dim): ``moe_apply_tp_plain`` summing in gloo's observed
    order gives the ranks' bits, the shared expert included; in rank order
    it is within LAYER_TOL of the reference."""
    ranks, ref, flat = runs
    shape = CASES["tp18"][0]
    cfg = get_smoke_config(ARCH)
    x = torch.from_numpy(hidden("tp18", cfg.d_model))
    order = TMOE.ObservedSumOrder.read(
        [torch.from_numpy(o) for o in ranks[0]["cases"]["tp18"]["order"]], shape[1], "cpu")
    y, aux = TMOE.moe_apply_tp_plain(layer_params(flat), x, cfg, *shape, reduce=order)
    assert_bits(global_y(ranks, "tp18", "auto"), y.numpy())
    y, aux = TMOE.moe_apply_tp_plain(layer_params(flat), x, cfg, *shape)
    close(y.numpy(), ref[f"tp18{SEP}auto{SEP}y"], LAYER_TOL)
    close(aux.numpy(), ref[f"tp18{SEP}auto{SEP}aux"], LAYER_TOL)
    for res in ranks:
        assert res["cases"]["tp18"]["ff_held"] == cfg.moe.d_ff_expert // shape[1]


def model_rows(ranks, mode, key):
    n_data, n_model = MODEL_MESH
    return np.concatenate([ranks[dc * n_model]["model"][mode][key] for dc in range(n_data)])


@pytest.mark.parametrize("mode", MODEL_MODES)
def test_model_under_rules_matches_the_reference(runs, mode):
    """DeepSeek smoke's forward and loss under rules (2, 4): each data
    shard's logits against the reference's rows, the aux, and ``ce``,
    ``mtp``, ``moe_aux`` and ``loss`` (each the mean over the data shards,
    each shard's over its own tokens) within MODEL_TOL; every rank holds
    one expert of each MoE layer and its ff slice of the shared expert,
    which runs as the tensor-parallel dense MLP."""
    ranks, ref, _ = runs
    close(model_rows(ranks, mode, "logits"), ref[f"model{SEP}{mode}{SEP}logits"], MODEL_TOL)
    n_data, n_model = MODEL_MESH
    for key in ("ce", "mtp", "moe_aux", "loss"):
        got = np.mean([ranks[dc * n_model]["model"][mode][key] for dc in range(n_data)])
        close(got, ref[f"model{SEP}{mode}{SEP}{key}"], MODEL_TOL)
    cfg = get_smoke_config(ARCH)
    for res in ranks:
        m = res["model"][mode]
        close(m["aux"], ref[f"model{SEP}{mode}{SEP}aux"], MODEL_TOL)
        assert m["experts_held"] == [cfg.moe.num_experts // n_model] * len(cfg.layer_kinds()
                                                                           * cfg.n_groups)
        assert m["shared_held"] == (cfg.d_model,
                                    cfg.moe.d_ff_expert * cfg.moe.shared_experts // n_model)


def test_model_under_rules_is_the_one_process_forward(runs):
    """The ranks' ``xla`` forward against the forward whose MoE layers are
    the one-process ``moe_apply_ep_plain`` over the data shard's model
    group (n_data 1), the dense layers tensor-parallel on both sides (the
    oracle runs in the ranks, on the whole experts): the logits bit for
    bit, and every MoE layer's routes and drops; and against the forward
    of one process (no rules, every leaf whole) within MODEL_TOL, the
    dense layers' partial sums in another order."""
    ranks, _, flat = runs
    cfg = get_smoke_config(ARCH)
    n_data, n_model = MODEL_MESH
    params = params_from_jax(unflatten(flat, "model"), cfg, device="cpu")
    tokens = model_tokens(cfg.vocab)
    auto = TMOE.moe_apply_auto
    TMOE.moe_apply_auto = lambda p, h, c: TMOE.moe_apply_ep_plain(p, h, c, 1, n_model)
    try:
        for dc in range(n_data):
            shard = torch.from_numpy(tokens[dc * len(tokens) // n_data:
                                            (dc + 1) * len(tokens) // n_data])
            logits = TM.forward_train(params, {"tokens": shard}, cfg, use_kernel=False)[0]
            got = [ranks[dc * n_model + j]["model"] for j in range(n_model)]
            for j in range(n_model):
                assert_bits(got[j]["xla"]["logits"], got[j]["oracle"]["logits"])
                close(got[j]["xla"]["logits"], logits.numpy(), MODEL_TOL)
            for li, (idx, keep) in enumerate(got[0]["oracle"]["routes"]):
                np.testing.assert_array_equal(
                    np.concatenate([g["xla"]["routes"][li][0] for g in got]), idx)
                np.testing.assert_array_equal(
                    np.concatenate([g["xla"]["routes"][li][1] for g in got]), keep)
    finally:
        TMOE.moe_apply_auto = auto


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("experts,top_k", [(8, 2), (32, 8)])
def test_combine_adds_as_the_reference_scatter_adds(dtype, experts, top_k):
    """``_combine`` adds each token's k entries to zeros one at a time in k
    order, in the activation dtype: the bits of the reference's
    ``out.at[src].add`` on the CPU, drops included, in bf16 too, where
    ``index_add_`` gives other bits at top-8 (it sums bf16 entries in
    float32 and rounds once)."""
    import jax.numpy as jnp

    base = get_smoke_config(ARCH)
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, num_experts=experts, top_k=top_k, capacity_factor=0.5))
    gen = torch.Generator().manual_seed(0)
    T, d = 64, base.d_model
    dt = getattr(torch, dtype)
    xt = torch.randn(T, d, generator=gen).to(dt)
    router = torch.randn(d, experts, generator=gen).to(dt)
    C = TMOE.ep_capacity(cfg, T)
    r = TMOE._route(xt, router, cfg, C)
    assert not bool(r.keep.all())
    back = torch.randn(experts, C, d, generator=gen).to(dt)
    got = TMOE._combine(back, r, T)
    g = back[r.flat_e, r.at]
    parts = torch.where(r.keep[:, None], g * r.w.reshape(-1)[:, None].to(dt), 0)
    want = jnp.zeros((T, d), dtype).at[jnp.asarray(r.src.numpy())].add(
        jnp.asarray(parts.float().numpy()).astype(dtype))
    assert_bits(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
