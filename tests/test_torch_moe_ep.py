"""The expert-parallel MoE path (``models.moe.moe_apply_ep``) over
``torch.distributed``, against the JAX package's ``moe_apply_ep``.

Eight gloo ranks on the CPU (spawned once for the module through
``repro_torch.launch.mesh.spawn``) lay themselves out as (data, model)
meshes with ``launch.mesh.make_mesh``, register rules with
``dist.sharding.set_active`` and run every case of ``CASES`` in all four
modes, plus Mixtral smoke's ``forward_train`` and ``loss_fn`` under rules
(2, 4) on each rank's compute leaves (``models.local_params``: the
attention, the embedding and the unembedding tensor-parallel, the logits
gathered over the vocabulary). The JAX side runs this file as a script on 8 forced host devices,
in a subprocess started beside the ranks:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/test_torch_moe_ep.py OUT.npz PARAMS.npz PART...

The module runs it twice at once, on ``JAX_PARTS``: the (2, 4) case,
whose four modes take the longest, and the rest. The second writes the
weights (``jax.random.key(0)``, as ``tests/moe_auto_check_script.py``
makes them) to PARAMS.npz first, which the ranks wait for. Hidden states
are ``default_rng(0)`` normals × 0.1, made by numpy on both sides.

Tolerances. Among the port's own modes, ``xla``, ``dragonfly`` and
``dragonfly_overlap`` are bit-identical (only the transport differs) and
so are the aux losses of all four. Against the JAX package every output
is held within ``LAYER_TOL`` (rtol = atol = 1e-5): the router product
``xt @ router`` of torch's CPU BLAS and of XLA's dot differ in the last
bit at these shapes, so the gates differ by an ulp and bit-exactness
across the packages cannot hold. The reference's own fused mode differs
from its other three by up to 3.26e-9 (its expert FFN contracts each
wave's stack in another order), far inside the tolerance; the aux agrees
within float32 rounding (the ``pmean`` sums in another order). The
routes are held exactly: the same expert ids and the same dropped
(token, k) entries. The module imports no jax (the JAX side imports it in
``jax_main``), so the ranks, which import it, start quickly.

The autotuner's ``auto`` mode runs on the same ranks (``AUTO_CASE``): its
decision is measured on the model groups and agreed by all 8 ranks, even
with rank ``SKEWED_RANK``'s own timings skewed, and its output is the bits
of the fixed mode it names, within LAYER_TOL of the reference's same
mode. A cold key decided while one rank alone holds a cache file ends
under a group timeout of ``AGREE_TIMEOUT_S`` with one decision on every
rank, and ``Engine.collective_report`` under the active rules gives the
reference's key, analytic strategy and rounds (the port's seeds set to
the reference's values there, ``JAX seeds`` below).
"""

import dataclasses
import datetime
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.dist import sharding as SH
from repro_torch.launch import mesh as LM
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import autotune as TA
from repro_torch.serve.engine import Engine

TESTS = pathlib.Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
ARCH = "mixtral-8x7b"
LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
MODES = ("xla", "dragonfly", "dragonfly_overlap", "dragonfly_overlap_fused")
EXCHANGE_ONLY = MODES[:3]
FUSED = MODES[3]

#: name -> (mesh (data, model), experts, capacity factor or None, tokens
#: (B, S), the modes the JAX side runs)
CASES = {
    "mesh24": ((2, 4), 4, None, (2, 16), MODES),
    "mesh18": ((1, 8), 8, None, (2, 16), ("xla", FUSED)),
    "drop": ((2, 4), 4, 0.5, (2, 64), ("xla", FUSED)),
}
MODEL_MESH = (2, 4)
MODEL_MODES = ("xla", FUSED)
MODEL_TOKENS = (2, 40)  # 40 tokens: the smoke config's window of 32 binds
#: the JAX side's two subprocesses: (writes the weights, the parts it runs)
JAX_PARTS = ((False, ("mesh24",)), (True, ("mesh18", "drop", "model")))
SEP = ":"
AUTO_CASE = "mesh24"  # the case the ``auto`` mode runs on: the reference ran all four modes
SKEWED_RANK = 3  # its own timings: the first candidate (native) slow, the rest instant
SKEW_US = 1e9
AGREE_TIMEOUT_S = 60  # the group timeout of the cold-key agreement cases
SPLIT_KEY = ("alltoall", 2, 2, 4096, "float32", "shard")  # D3(2,2): all 8 ranks
SPLIT_CACHED = "overlap"  # the strategy the one rank's cache file records
ENGINE_SLOTS = 4


def case_cfg(cfg, name):
    """The case's config: Mixtral smoke with its experts and capacity
    factor replaced, the same way on both sides."""
    _, experts, cf, _, _ = CASES[name]
    changes = {"num_experts": experts}
    if cf is not None:
        changes["capacity_factor"] = cf
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **changes))


def hidden(name, d):
    B, S = CASES[name][3]
    return (np.random.default_rng(0).standard_normal((B, S, d)) * 0.1).astype(np.float32)


def model_tokens(vocab):
    return np.random.default_rng(12).integers(1, vocab, MODEL_TOKENS).astype(np.int32)


def flatten(tree, prefix, out):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        out[prefix] = np.asarray(tree)
        return
    for key, val in items:
        flatten(val, f"{prefix}{SEP}{key}", out)


def unflatten(flat, prefix):
    tree = {}
    for key, val in flat.items():
        if not key.startswith(prefix + SEP):
            continue
        *path, leaf = key[len(prefix) + 1:].split(SEP)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = val
    return _lists(tree)


def _lists(node):
    """Dicts keyed 0..n-1 back into lists."""
    if not isinstance(node, dict):
        return node
    node = {key: _lists(val) for key, val in node.items()}
    if node and all(key.isdigit() for key in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def wait_for(path: pathlib.Path, proc, timeout: float = 300.0):
    t0 = time.monotonic()
    while not path.exists():
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(f"the JAX side exited with {proc.returncode} before {path.name}")
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"no {path} after {timeout} s")
        time.sleep(0.2)


# -------------------------------------------------- the port's side: a rank
def _data_shard(a, coords, n_data):
    B = a.shape[0]
    dc = coords["data"]
    return a[dc * B // n_data:(dc + 1) * B // n_data]


def run_auto(rank, mesh, params, x, cfg, root: pathlib.Path):
    """``moe_collectives="auto"`` on this rank, twice (the second call a
    memo hit), with a measuring tuner of its own cache file; on
    SKEWED_RANK ``_time_us`` reports SKEW_US for the first candidate and 0
    for the rest, though it still runs every timed call."""
    tuner = TA.Autotuner(cache_path=root / f"auto-{rank}.json", device="cpu")
    TA.set_autotuner(tuner)
    real = TA._time_us
    seen = []

    def skewed(fn, *args, **kw):
        seen.append(real(fn, *args, **kw))
        return SKEW_US if len(seen) == 1 else 0.0

    if rank == SKEWED_RANK:
        TA._time_us = skewed
    try:
        SH.set_active(SH.ShardRules(moe_collectives="auto"), mesh)
        y, aux = TMOE.moe_apply_ep(params, x, cfg)
        n = len(tuner.decisions)
        y2, _ = TMOE.moe_apply_ep(params, x, cfg)
        memo_hit = len(tuner.decisions) == n
    finally:
        TA._time_us = real
        TA.set_autotuner(None)
    dec = tuner.decisions[-1]
    return {"strategy": dec.strategy, "source": dec.source, "key": str(dec.key),
            "measured_us": dict(dec.measured_us), "y": y.numpy(), "aux": aux.numpy(),
            "y2": y2.numpy(), "memo_hit": memo_hit, "decisions": len(tuner.decisions),
            "skewed_calls": len(seen), "wrote": (root / f"auto-{rank}.json").exists()}


def run_split_cache(rank, root: pathlib.Path):
    """A cold D3(2,2) shard key decided by all 8 ranks over a group with a
    timeout of its own, while one rank alone (3, then 0) holds a cache
    file recording SPLIT_CACHED for it. Returns {holder: (strategy,
    source, measured µs)}."""
    g = torch.distributed.new_group(list(range(8)),
                                    timeout=datetime.timedelta(seconds=AGREE_TIMEOUT_S))
    key = str(TA.TuneKey(*SPLIT_KEY))
    out = {}
    for holder in (SKEWED_RANK, 0):
        path = root / f"split-{holder}-{rank}.json"
        if rank == holder:
            path.write_text(json.dumps({"schema": TA.SCHEMA_VERSION, "device": "cpu", "entries": {
                key: {"strategy": SPLIT_CACHED, "measured_us": {SPLIT_CACHED: 1.0}}}}))
        tuner = TA.Autotuner(cache_path=path, device="cpu")
        d = tuner.decide("alltoall", TA.layout_for(8), SPLIT_KEY[3], site="shard", group=g)
        out[holder] = (d.strategy, d.source, dict(d.measured_us))
    return out


def run_reports(rank, cfg, tp, jax_seeds, root: pathlib.Path):
    """``Engine.collective_report`` under the active rules: analytic with
    the port's seeds set to the reference's (restored after), and measured
    on the model groups, agreed by every rank."""
    eng = Engine(cfg, tp, batch_slots=ENGINE_SLOTS, max_seq=16, device="cpu")
    kept = {name: getattr(TA, name) for name in jax_seeds}
    try:
        for name, value in jax_seeds.items():
            setattr(TA, name, value)
        analytic = eng.collective_report(tuner=TA.Autotuner(
            cache_path=root / f"report-a-{rank}.json", mode="analytic", device="cpu"))
    finally:
        for name, value in kept.items():
            setattr(TA, name, value)
    measured = eng.collective_report(tuner=TA.Autotuner(
        cache_path=root / f"report-m-{rank}.json", device="cpu"))
    return {"analytic": analytic, "measured": measured}


def run_rank(rank, group, layout, params_path, jax_seeds):
    """Every case in every mode on this rank, the ``auto`` mode and its
    agreement cases, and the model under rules with the engine's report.
    Returns host data."""
    root = pathlib.Path(params_path).parent
    with np.load(params_path) as f:
        flat = dict(f)
    base = get_smoke_config(ARCH)
    out = {"cases": {}, "model": {}}
    for name, (shape, _, _, _, _) in CASES.items():
        cfg = case_cfg(base, name)
        mesh = LM.make_mesh(shape, ("data", "model"), device="cpu")
        params = {k: torch.from_numpy(v) for k, v in unflatten(flat, f"layer{SEP}{name}").items()}
        x = torch.from_numpy(_data_shard(hidden(name, cfg.d_model), mesh.coords, shape[0]))
        res = {}
        for mode in MODES:
            SH.set_active(SH.ShardRules(moe_collectives=mode), mesh)
            with TMOE.recording_routes() as routes:
                y, aux = TMOE.moe_apply_ep(params, x, cfg)
            (idx, keep, _), = routes
            res[mode] = (y.numpy(), aux.numpy(), idx.numpy(), keep.numpy())
        if name == AUTO_CASE:
            res["auto"] = run_auto(rank, mesh, params, x, cfg, root)
        # the expert stacks already cut to this rank's rows, through
        # moe_apply_auto, which takes the EP path under these rules
        cut = TMOE.local_experts(params, cfg, SH.active()[0], mesh.coords, mesh.sizes)
        SH.set_active(SH.ShardRules(moe_collectives="xla"), mesh)
        y, aux = TMOE.moe_apply_auto(cut, x, cfg)
        res["xla-cut-auto"] = (y.numpy(), aux.numpy(), cut["w_in"].shape[0])
        res["mesh"] = {"coords": mesh.coords, "sizes": dict(SH.active()[0].__dict__),
                       "transport": mesh.transport, "carrier": str(mesh.carrier),
                       "carrier_copies": mesh.carrier_copies,
                       "group_rank": torch.distributed.get_rank(mesh.group("model")),
                       "group_size": torch.distributed.get_world_size(mesh.group("model"))}
        out["cases"][name] = res

    cfg = get_smoke_config(ARCH)
    mesh = LM.make_mesh(MODEL_MESH, ("data", "model"), device="cpu")
    tokens = torch.from_numpy(_data_shard(model_tokens(cfg.vocab), mesh.coords, MODEL_MESH[0]))
    batch = {"tokens": tokens, "labels": tokens}
    whole = params_from_jax(unflatten(flat, "model"), cfg, device="cpu")
    for mode in MODEL_MODES:
        rules = SH.ShardRules(moe_collectives=mode)
        SH.set_active(rules, mesh)
        tp = params_from_jax(unflatten(flat, "model"), cfg, device="cpu",
                             rules=SH.active()[0], rank=rank)
        # the train path takes the rank's compute leaves: the dense ones cut
        # on the model axis too, the logits cut on the vocabulary
        lp = TM.local_params(whole, cfg, SH.active()[0], mesh.coords, mesh.sizes)
        logits, aux, _ = TM.forward_train(lp, batch, cfg, use_kernel=False)
        loss, metrics = TM.loss_fn(lp, batch, cfg, use_kernel=False)
        out["model"][mode] = {"logits": TM.whole_logits(logits).numpy(), "aux": aux.numpy(),
                              "loss": loss.numpy(), "ce": metrics["ce"].numpy(),
                              "experts_held": lp["stack"][0]["ffn"]["w_in"].shape[0]}
    out["reports"] = run_reports(rank, cfg, tp, jax_seeds, root)
    SH.clear_active()
    out["split_cache"] = run_split_cache(rank, root)
    try:
        LM.make_production_mesh(device="cpu")
        out["production"] = None
    except ValueError as e:
        out["production"] = str(e)
    return out


# ------------------------------------ the JAX side: this file as a script
def jax_main(out: str, params_out: str, parts) -> None:
    """The weights to ``params_out`` first (unless it is "-"), then the
    ``parts`` (case names and "model") through the JAX package on 8 forced
    host devices: ``moe_apply_ep`` in the case's modes, and the model under
    rules. Saved to ``out`` (.npz)."""
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
    cfgs = {name: case_cfg(base, name) for name in CASES}
    flat = {}
    params = {name: JMOE.moe_init(jax.random.key(0), cfgs[name], jnp.float32) for name in CASES}
    for name, p in params.items():
        flatten(jax.tree.map(np.asarray, p), f"layer{SEP}{name}", flat)
    jp = JM.init_params(jax.random.key(0), base)
    flatten(jax.tree.map(np.asarray, jp), "model", flat)
    if params_out != "-":
        tmp = params_out + ".tmp.npz"
        np.savez(tmp, **flat)
        os.replace(tmp, params_out)

    results = {}
    for name, (shape, _, _, tokens, jax_modes) in CASES.items():
        if name not in parts:
            continue
        cfg, p = cfgs[name], params[name]
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape), ("data", "model"))
        x = hidden(name, cfg.d_model)
        for mode in jax_modes:
            JSH.set_active(JSH.ShardRules(moe_collectives=mode), mesh)
            y, aux = JMOE.moe_apply_ep(p, jnp.asarray(x), cfg)
            results[f"{name}{SEP}{mode}{SEP}y"] = np.asarray(y)
            results[f"{name}{SEP}{mode}{SEP}aux"] = np.asarray(aux)
        JSH.clear_active()
        # the reference's routes, shard by shard: top-k ids and kept entries
        m = cfg.moe
        T_loc = tokens[0] * tokens[1] // 8
        C = max(8, int(m.capacity_factor * T_loc * m.top_k / m.num_experts))
        C = -(-C // 8) * 8
        xt = x.reshape(8, T_loc, -1)
        ids, keeps = [], []
        for s in range(8):
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
    for mode in MODEL_MODES if "model" in parts else ():
        JSH.set_active(JSH.ShardRules(moe_collectives=mode), mesh)
        logits, aux, _ = JM.forward_train(jp, batch, base, use_kernel=False)
        loss, metrics = JM.loss_fn(jp, batch, base, use_kernel=False)
        for key, val in (("logits", logits), ("aux", aux), ("loss", loss),
                         ("ce", metrics["ce"])):
            results[f"model{SEP}{mode}{SEP}{key}"] = np.asarray(val)
    JSH.clear_active()
    np.savez(out, **results)


if __name__ == "__main__":
    jax_main(sys.argv[1], sys.argv[2], sys.argv[3:])


# ------------------------------------------------------------------- tests
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(per-rank results of the port, {key: JAX result}, the weights): the
    JAX subprocesses start first, one writes the weights, and the 8 gloo
    ranks run beside them once the weights are there."""
    root = tmp_path_factory.mktemp("moe_ep")
    params = root / "params.npz"
    path = os.pathsep.join([str(SRC), str(TESTS), os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=path)
    procs = [subprocess.Popen([sys.executable, __file__, str(root / f"ref{i}.npz"),
                               str(params) if writes else "-", *parts],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for i, (writes, parts) in enumerate(JAX_PARTS)]
    from repro.runtime import autotune as JA

    jax_seeds = {name: getattr(JA, "T_XLA" if name == "T_NATIVE" else name)
                 for name in ("T_W", "BANDWIDTH", "T_DISPATCH", "T_GROUP", "T_KERNEL",
                              "T_NATIVE", "T_TRACE_OP", "COMPUTE_RATE")}
    try:
        wait_for(params, procs[[w for w, _ in JAX_PARTS].index(True)])
        ranks = LM.spawn(run_rank, 8, device="cpu", args=(str(params), jax_seeds))
    finally:
        logs = [proc.communicate(timeout=900)[0] for proc in procs]
    ref = {}
    for i, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, log
        with np.load(root / f"ref{i}.npz") as part:
            ref.update(part)
    with np.load(params) as flat:
        return ranks, ref, dict(flat)


def assert_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(np.ascontiguousarray(got).view(np.uint8),
                                  np.ascontiguousarray(want).view(np.uint8))


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def global_y(ranks, name, mode):
    """The whole (B, S, d) output: each data shard from the model group's
    first rank (every rank of a model group holds the same shard)."""
    n_data, n_model = CASES[name][0]
    return np.concatenate([ranks[dc * n_model]["cases"][name][mode][0] for dc in range(n_data)])


@pytest.mark.parametrize("name,mode", [(n, m) for n in CASES for m in MODES])
def test_ep_layer_matches_the_reference(runs, name, mode):
    """Each mode against the reference's same mode where it ran, else its
    ``xla`` mode (its three exchange-only modes are bit-identical, checked
    in the (2, 4) case), within LAYER_TOL; the aux too."""
    ranks, ref, _ = runs
    jax_modes = CASES[name][4]
    want = mode if mode in jax_modes else "xla"
    close(global_y(ranks, name, mode), ref[f"{name}{SEP}{want}{SEP}y"], LAYER_TOL)
    for r in ranks:
        close(r["cases"][name][mode][1], ref[f"{name}{SEP}{want}{SEP}aux"], LAYER_TOL)
    # every rank of a model group holds its data shard's whole output
    n_model = CASES[name][0][1]
    for r, res in enumerate(ranks):
        assert_bits(res["cases"][name][mode][0], ranks[r - r % n_model]["cases"][name][mode][0])


def test_reference_exchange_modes_are_bit_identical(runs):
    """The premise of comparing the port's dragonfly modes with the
    reference's xla mode where only that ran; the fused mode differs by
    float order only."""
    _, ref, _ = runs
    for mode in EXCHANGE_ONLY[1:]:
        assert_bits(ref[f"mesh24{SEP}{mode}{SEP}y"], ref[f"mesh24{SEP}xla{SEP}y"])
    close(ref[f"mesh24{SEP}{FUSED}{SEP}y"], ref[f"mesh24{SEP}xla{SEP}y"], LAYER_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_port_exchange_modes_are_bit_identical(runs, name):
    """Only the transport differs between xla, dragonfly and
    dragonfly_overlap: the same bits on every rank. The fused mode within
    LAYER_TOL of them, and the aux the same in all four."""
    ranks, _, _ = runs
    for res in ranks:
        r = res["cases"][name]
        for mode in EXCHANGE_ONLY[1:]:
            assert_bits(r[mode][0], r["xla"][0])
        close(r[FUSED][0], r["xla"][0], LAYER_TOL)
        for mode in MODES[1:]:
            assert_bits(r[mode][1], r["xla"][1])
        assert r["xla"][1] == ranks[0]["cases"][name]["xla"][1]  # the pmean is every rank's


@pytest.mark.parametrize("name", list(CASES))
def test_ep_routes_and_drops_are_the_reference(runs, name):
    """The same expert ids and the same dropped (token, k) entries, shard
    by shard (rank r routes shard r: data-major, as PS((data, model)));
    the drop case drops 28 of its 256 entries, the others none."""
    ranks, ref, _ = runs
    for mode in MODES:
        idx = np.stack([res["cases"][name][mode][2] for res in ranks])
        keep = np.stack([res["cases"][name][mode][3] for res in ranks])
        np.testing.assert_array_equal(idx, ref[f"{name}{SEP}idx"])
        np.testing.assert_array_equal(keep, ref[f"{name}{SEP}keep"])
    assert int((~keep).sum()) == (28 if name == "drop" else 0)


@pytest.mark.parametrize("name", list(CASES))
def test_ep_plain_matches_the_reference_and_the_ranks(runs, name):
    """``moe_apply_ep_plain`` in one process against the reference's xla
    mode (LAYER_TOL) and the ranks' xla mode (bit for bit: the same routes,
    the same batched products, the same combine)."""
    ranks, ref, flat = runs
    shape = CASES[name][0]
    cfg = case_cfg(get_smoke_config(ARCH), name)
    params = {k: torch.from_numpy(v) for k, v in unflatten(flat, f"layer{SEP}{name}").items()}
    x = torch.from_numpy(hidden(name, cfg.d_model))
    y, aux = TMOE.moe_apply_ep_plain(params, x, cfg, *shape)
    close(y.numpy(), ref[f"{name}{SEP}xla{SEP}y"], LAYER_TOL)
    close(aux.numpy(), ref[f"{name}{SEP}xla{SEP}aux"], LAYER_TOL)
    assert_bits(y.numpy(), global_y(ranks, name, "xla"))
    close(aux.numpy(), ranks[0]["cases"][name]["xla"][1], LAYER_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_cut_weights_and_auto_take_the_same_path(runs, name):
    """Expert stacks cut to the rank's rows by ``moe_specs`` give the
    bits of the whole stacks, and ``moe_apply_auto`` takes the EP path
    under the rules."""
    ranks, _, _ = runs
    E_loc = CASES[name][1] // CASES[name][0][1]
    for res in ranks:
        y, aux, held = res["cases"][name]["xla-cut-auto"]
        assert held == E_loc
        assert_bits(y, res["cases"][name]["xla"][0])
        assert_bits(aux, res["cases"][name]["xla"][1])


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_groups_sizes_and_carrier(runs, name):
    """``make_mesh`` lays ranks out row-major with the model axis fastest,
    the model group's rank order is the model coordinate (router order),
    ``set_active`` re-derives the axis sizes from the mesh, and gloo ranks
    on the CPU carry their exchanges on the CPU with no copy."""
    ranks, _, _ = runs
    n_data, n_model = CASES[name][0]
    for r, res in enumerate(ranks):
        m = res["cases"][name]["mesh"]
        assert m["coords"] == {"data": r // n_model, "model": r % n_model}
        assert m["sizes"]["model_axis_size"] == n_model
        assert m["sizes"]["data_axis_size"] == n_data
        assert (m["group_rank"], m["group_size"]) == (r % n_model, n_model)
        assert (m["transport"], m["carrier"], m["carrier_copies"]) == ("gloo", "cpu", 0)


@pytest.mark.parametrize("mode", MODEL_MODES)
def test_model_under_rules_matches_the_reference(runs, mode):
    """Mixtral smoke's forward and loss under rules (2, 4): each data
    shard's logits against the reference's rows, the aux and the loss (the
    mean over the data shards' losses, each over its own tokens) within
    MODEL_TOL; every rank holds one expert of each layer."""
    ranks, ref, _ = runs
    n_data, n_model = MODEL_MESH
    logits = np.concatenate([ranks[dc * n_model]["model"][mode]["logits"]
                             for dc in range(n_data)])
    close(logits, ref[f"model{SEP}{mode}{SEP}logits"], MODEL_TOL)
    loss = np.mean([ranks[dc * n_model]["model"][mode]["loss"] for dc in range(n_data)])
    ce = np.mean([ranks[dc * n_model]["model"][mode]["ce"] for dc in range(n_data)])
    close(loss, ref[f"model{SEP}{mode}{SEP}loss"], MODEL_TOL)
    close(ce, ref[f"model{SEP}{mode}{SEP}ce"], MODEL_TOL)
    for res in ranks:
        close(res["model"][mode]["aux"], ref[f"model{SEP}{mode}{SEP}aux"], MODEL_TOL)
        assert res["model"][mode]["experts_held"] == 1


def test_production_mesh_refuses_a_world_of_eight(runs):
    ranks, _, _ = runs
    for res in ranks:
        assert "needs 256 ranks" in res["production"] and "has 8" in res["production"]


# ------------------------------------------------------- the auto mode
def test_auto_decision_is_the_same_on_every_rank(runs):
    """One decision on all 8 ranks, measured once (the second call is a
    memo hit), keyed as the reference keys it, with every rank's times the
    MAX over the ranks: SKEWED_RANK's slow first candidate reached every
    rank, while its instant others did not win there. Only the first rank
    of the mesh wrote its cache file."""
    ranks, _, _ = runs
    autos = [res["cases"][AUTO_CASE]["auto"] for res in ranks]
    first = autos[0]
    assert first["source"] == "measured" and first["strategy"] in TA.EP_MODE
    assert set(first["measured_us"]) == {"native", "loop", "overlap", "overlap_fused"}
    assert first["measured_us"]["native"] == SKEW_US and first["strategy"] != "native"
    for r, a in enumerate(autos):
        assert (a["strategy"], a["source"], a["key"]) == (
            first["strategy"], first["source"], first["key"]), r
        assert a["measured_us"] == first["measured_us"], r
        assert a["memo_hit"] and a["decisions"] == 1
        assert a["wrote"] == (r == 0)
    assert autos[SKEWED_RANK]["skewed_calls"] == 4
    cfg = case_cfg(get_smoke_config(ARCH), AUTO_CASE)
    m, (n_data, n_model) = cfg.moe, CASES[AUTO_CASE][0]
    B, S = CASES[AUTO_CASE][3]
    t_loc = B * S // (n_data * n_model)
    c_loc = TMOE.ep_capacity(cfg, t_loc)
    want = TA.TuneKey("alltoall", n_model, 1, TA.bucket_bytes(
        m.num_experts // n_model * c_loc * cfg.d_model * 4), "float32", "shard",
        TA.bucket_compute_us(TA.moe_compute_us(m.num_experts // n_model, c_loc, n_model,
                                               cfg.d_model, m.d_ff_expert)))
    assert first["key"] == str(want)


def test_auto_output_is_the_named_fixed_modes(runs):
    """The ``auto`` output and aux are the bits of the fixed mode the
    decision names, on every rank and in both calls, and within LAYER_TOL
    of the reference's ``moe_apply_ep`` in that mode."""
    ranks, ref, _ = runs
    mode = TA.EP_MODE[ranks[0]["cases"][AUTO_CASE]["auto"]["strategy"]]
    for res in ranks:
        r = res["cases"][AUTO_CASE]
        assert_bits(r["auto"]["y"], r[mode][0])
        assert_bits(r["auto"]["y2"], r[mode][0])
        assert_bits(r["auto"]["aux"], r[mode][1])
    n_data, n_model = CASES[AUTO_CASE][0]
    y = np.concatenate([ranks[dc * n_model]["cases"][AUTO_CASE]["auto"]["y"]
                        for dc in range(n_data)])
    close(y, ref[f"{AUTO_CASE}{SEP}{mode}{SEP}y"], LAYER_TOL)


@pytest.mark.parametrize("holder", [SKEWED_RANK, 0])
def test_cold_key_with_one_cache_file_agrees(runs, holder):
    """One rank holds a cache file, the others none: all 8 end (under their
    group's timeout) with one decision. The first rank's view decides:
    its file's entry where it holds one, else every rank measures."""
    ranks, _, _ = runs
    got = [res["split_cache"][holder] for res in ranks]
    assert all(g == got[0] for g in got)
    strategy, source, measured = got[0]
    if holder == 0:
        assert (strategy, source) == (SPLIT_CACHED, "cache")
    else:
        assert source == "measured" and set(measured) == {
            "native", "loop", "overlap", "overlap_fused"}


def test_engine_collective_report_is_the_references(runs, tmp_path):
    """``Engine.collective_report`` under the active (2, 4) rules: the
    reference engine's key, strategy, rounds and hops (analytic, the
    reference's seeds), and measured on the model groups, one decision on
    every rank."""
    from repro.configs import get_smoke_config as j_smoke
    from repro.dist.sharding import ShardRules as JRules
    from repro.runtime import autotune as JA
    from repro.serve.engine import Engine as JEngine

    ranks, _, _ = runs
    n_data, n_model = MODEL_MESH
    want = JEngine(j_smoke(ARCH), None, ENGINE_SLOTS, 16).collective_report(
        rules=JRules(model_axis_size=n_model, data_axis_size=n_data),
        tuner=JA.Autotuner(cache_path=tmp_path / "j.json", mode="analytic"))
    for res in ranks:
        got = res["reports"]["analytic"]
        for field in ("status", "topology", "key", "source", "rounds", "priced_hops",
                      "moe_collectives"):
            assert got[field] == want[field], field
        assert got["strategy"] == TA.RENAMED.get(want["strategy"], want["strategy"])
    measured = [res["reports"]["measured"] for res in ranks]
    assert measured[0]["source"] == "measured" and measured[0]["key"] == want["key"]
    for got in measured:
        assert (got["strategy"], got["measured_us"]) == (measured[0]["strategy"],
                                                         measured[0]["measured_us"])
