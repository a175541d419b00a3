"""The Mamba, mLSTM and sLSTM mixers under tensor parallelism: the train
path (``models.forward_train`` and ``loss_fn`` on the rank's compute
leaves, ``models.local_params``), the decode (``models.decode_step`` with
each recurrent state at its ``cache_specs`` shard) and the sharded step
(``train.train_step.make_sharded_train_step``), against the JAX package;
the new tensor-axis pair (``dist.collectives.fetch_columns``) and the
dry run's xLSTM decode cell.

Eight gloo ranks on the CPU (spawned once for the module through
``repro_torch.launch.mesh.spawn``) lay themselves out as (data, model)
meshes: Jamba smoke (Mamba, d_inner 128: 32 channels a rank) and xLSTM
smoke (7 mLSTM of 4 heads and 1 sLSTM) on (2, 4), and xLSTM smoke on
(1, 8) too, where its 4 heads spread over 8 ranks, two a head, as
xLSTM-1.3B's 4 over a model axis of 16. Each runs the forward and the
loss with and without ``seq_parallel``, and two decode steps on the
rank's shard of a filled cache. The JAX side runs this file as a script
on 8 forced host devices, in subprocesses started beside the ranks:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/test_torch_recurrent_tp.py forward OUT.npz INPUTS.npz
    ... decode OUT.npz INPUTS.npz
    ... step OUT.npz INPUTS.npz

the reference's ``jax.jit`` of ``forward_train`` and ``loss_fn`` under
``param_specs``' shardings (``seq_parallel`` as given), of
``decode_step`` under ``param_specs`` and ``cache_specs``, and the steps
of ``make_train_step`` under ``train_shardings`` (through
``tests/test_torch_train_sharded.py``'s ``jax_main``), each writing its
inputs (``jax.random.key(0)`` parameters, tokens, filled caches) first,
which the ranks wait for.

Tolerances: the logits (gathered over the vocabulary), the loss and
``ce`` within ``MODEL_TOL`` (1e-4) of the reference's; the decode's
logits within MODEL_TOL and each rank's shard of every recurrent state
within ``CACHE_TOL`` (1e-5) of the same shard of the reference's new
state; the sharded step's gathered state after two steps as
``tests/test_torch_train_sharded.py`` holds it (Jamba smoke with FSDP on
(2, 4)), and xLSTM smoke's likewise after one step through its first
moment (``STEPS``); the pair's adjoints in float64 within
``ADJOINT_TOL`` (1e-12). Planted faults that must leave MODEL_TOL: the
stored ``w_in`` shard used as ``[x | z]`` of the rank's channels, the
sLSTM step on the rank's own ``h`` with no gather, the mLSTM norm
without the sum of squares over the axis.
"""

import contextlib
import copy
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_smoke_config
from repro_torch.dist import collectives as CL
from repro_torch.dist import sharding as SH
from repro_torch.launch import mesh as LM
from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models import model as TM
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as XL
from repro_torch.models.convert import _unstack, params_from_jax
from repro_torch.train import optimizer as O

from test_torch_moe_ep import SEP, assert_bits, close, flatten, unflatten, wait_for

TESTS = pathlib.Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
MODEL_TOL = 1e-4
CACHE_TOL = 1e-5
ADJOINT_TOL = 1e-12
AXES = ("data", "model")
JAMBA, XLSTM = "jamba-1.5-large-398b", "xlstm-1.3b"
ARCHS = (JAMBA, XLSTM)
#: name -> (arch, mesh (data, model))
RUNS = {"jamba24": (JAMBA, (2, 4)), "xlstm24": (XLSTM, (2, 4)), "xlstm18": (XLSTM, (1, 8))}
MODES = {"tp": False, "sp": True}  # name -> seq_parallel
ROWS, SEQ = 8, 16
#: the decode: rows, cache positions, the two steps' positions
B, MAX_SEQ, POS = 8, 32, (20, 21)
#: the sharded step's cases: ``tests/test_torch_train_sharded.py``'s
#: ``jamba`` and this file's ``xlstm`` (added to its ``CASES`` where it runs)
STEP_CASES = {"jamba": None, "xlstm": ("xlstm-1.3b", (2, 4), {"fsdp": True}, 1, 4, False)}
#: steps each case takes: xLSTM smoke's parameters after a second Adam step
#: are 2.55e-4 off the reference's in the port's one-process step already
#: (a leaf whose two steps' gradients nearly cancel), so its sharded step
#: is held after one, through the first moment (0.1 of the clipped gradient)
STEPS = {"jamba": 2, "xlstm": 1}
FAULTS = {"unpaired_w_in": "jamba24", "slstm_own_h": "xlstm24", "mlstm_norm_unsummed": "xlstm24"}
#: (what each of 4 ranks wants, stored columns a rank) of each case of
#: ``fetch_columns``: channel blocks of 2 and 4 parts (``part_wants``), and
#: an mLSTM's ``[x | gate]`` of 2 heads over 4 ranks, each rank fetching
#: the x columns of the head its block touches (each of them wanted by two
#: ranks) and its block of the gate
EXCHANGES = {"parts2": (CL.part_wants(2, 32, 4), 8), "parts4": (CL.part_wants(4, 64, 4), 16),
             "parts4_wide": (CL.part_wants(4, 16, 4), 4),
             "heads": (tuple(((c // 2 * 8, c // 2 * 8 + 8), (16 + 4 * c, 20 + 4 * c))
                             for c in range(4)), 8)}


def tokens(vocab, shape):
    return np.random.default_rng(3).integers(1, vocab, shape).astype(np.int32)


def rows_of(a, coords, n_data):
    step = a.shape[0] // n_data
    return a[coords["data"] * step:(coords["data"] + 1) * step]


@contextlib.contextmanager
def step_cases():
    """``tests/test_torch_train_sharded.py``'s ``CASES`` with this file's
    cases added, for the block."""
    import test_torch_train_sharded as TSH

    added = {k: v for k, v in STEP_CASES.items() if v is not None}
    TSH.CASES.update(added)
    try:
        yield TSH
    finally:
        for k in added:
            del TSH.CASES[k]


@contextlib.contextmanager
def patched(owner, name, value):
    """``owner``'s attribute (or a dict's entry) ``name`` set to ``value`` for
    the block."""
    get, put = ((dict.__getitem__, dict.__setitem__) if isinstance(owner, dict)
                else (getattr, setattr))
    real = get(owner, name)
    put(owner, name, value)
    try:
        yield
    finally:
        put(owner, name, real)


# ------------------------------------------------- the port's side: a rank
def forward_and_loss(params, batch, cfg):
    logits, _, _ = TM.forward_train(params, batch, cfg, use_kernel=False)
    loss, metrics = TM.loss_fn(params, batch, cfg, use_kernel=False)
    return {"logits": TM.whole_logits(logits).detach().numpy(),
            "loss": loss.detach().numpy(), "ce": metrics["ce"].detach().numpy()}


def forward(run, flat, mesh, **kw):
    arch, shape = RUNS[run]
    cfg = get_smoke_config(arch)
    whole = params_from_jax(unflatten(flat, f"params{SEP}{arch}"), cfg, device="cpu")
    t = torch.from_numpy(rows_of(flat[f"tokens{SEP}{arch}"], mesh.coords, shape[0])).long()
    SH.set_active(SH.ShardRules(**kw), mesh)
    try:
        lp = TM.local_params(whole, cfg, SH.active()[0], mesh.coords, mesh.sizes)
        return forward_and_loss(lp, {"tokens": t, "labels": t}, cfg)
    finally:
        SH.clear_active()


def port_cache(flat, prefix, cfg):
    return _unstack(unflatten(flat, prefix), cfg, lambda a: torch.tensor(np.asarray(a)))


def shard_of(whole, spec, coords, sizes):
    return whole[SH.local_slices(spec, whole.shape, coords, sizes)]


def decode(run, flat, mesh):
    """Two decode steps on the rank's shard of every cache leaf: (logits of
    each step, the new cache's leaves by path)."""
    arch, shape = RUNS[run]
    cfg = get_smoke_config(arch)
    whole = params_from_jax(unflatten(flat, f"params{SEP}{arch}"), cfg, device="cpu")
    cache = port_cache(flat, f"cache{SEP}{arch}", cfg)
    toks = flat[f"dtokens{SEP}{arch}"]
    SH.set_active(SH.ShardRules(), mesh)
    try:
        rules = SH.active()[0]
        cspecs = TM.cache_specs(cfg, rules, False)
        lp = TM.local_params(whole, cfg, rules, mesh.coords, mesh.sizes)
        mine = O.unflatten(cache, [shard_of(t, O.get(cspecs, path), mesh.coords,
                                            mesh.sizes).clone() for path, t in O.flatten(cache)])
        logits = []
        with torch.no_grad():
            for step, pos in enumerate(POS):
                tok = torch.from_numpy(rows_of(toks[step], mesh.coords, shape[0])).long()
                out, mine = TM.decode_step(lp, mine, {"token": tok}, pos, cfg)
                logits.append(out.numpy())
    finally:
        SH.clear_active()
    return {"logits": logits,
            "cache": {SEP.join(map(str, path)): t.numpy() for path, t in O.flatten(mine)}}


def replaced(tp, name, fn):
    """A copy of the tensor axis ``tp`` whose method ``name`` is ``fn``."""
    bad = copy.copy(tp)
    setattr(bad, name, fn)
    return bad


def own_block_only(tp):
    """The planted sLSTM step's axis: its all-gather gives the rank's own
    block among zeros for the other ranks' (the step on its own ``h``, no
    gather)."""
    def gather_last(h):
        out = h.new_zeros((*h.shape[:-1], h.shape[-1] * tp.size))
        out[..., tp.coord * h.shape[-1]:(tp.coord + 1) * h.shape[-1]] = h
        return out

    return replaced(tp, "gather_last", gather_last)


def faults(flat, meshes):
    """Each planted fault's forward: the exchange of the stored ``[x | z]``
    columns dropped; the sLSTM given ``own_block_only``'s axis; the norm
    given an axis whose sum is the identity."""
    init, train, dec, state = T._RECURRENT["slstm"]
    norm = L.rmsnorm
    plants = {
        "unpaired_w_in": (CL.TensorParallel, "own_parts", lambda self, x, parts: x),
        "slstm_own_h": (T._RECURRENT, "slstm", (
            init, lambda p, x, cfg, tp=None: train(p, x, cfg, tp=own_block_only(tp)), dec, state)),
        "mlstm_norm_unsummed": (L, "rmsnorm", lambda p, x, eps=1e-5, tp=None: norm(
            p, x, eps, tp=None if tp is None else replaced(tp, "sum", lambda t: t)))}
    out = {}
    for name, plant in plants.items():
        run = FAULTS[name]
        with patched(*plant):
            out[name] = forward(run, flat, meshes[RUNS[run][1]])
    return out


def adjoints(mesh):
    """<A x, y> and <x, Aᵀ y> on this rank, float64, for ``fetch_columns``
    on the model axis (4 ranks) and ``TensorParallel.gather_last``."""
    group = mesh.group("model")
    gen = torch.Generator().manual_seed(300 + mesh.rank)
    ops = {name: (lambda x, wants=wants: CL.fetch_columns(x, wants, group, mesh=mesh), cols)
           for name, (wants, cols) in EXCHANGES.items()}
    ops["gather_last"] = (CL.TensorParallel(SH.ShardRules(), mesh).gather_last, 3)
    out = {}
    for op, (fn, cols) in ops.items():
        x = torch.randn((2, 5, cols), generator=gen, dtype=torch.float64).requires_grad_(True)
        ax = fn(x)
        y = torch.randn(ax.shape, generator=gen, dtype=torch.float64)
        (aty,) = torch.autograd.grad(ax, x, y)
        out[op] = (float((ax * y).sum()), float((x * aty).sum()))
    return out


def exchanged(mesh):
    """Each ``EXCHANGES`` case on a known leaf: the rank's result and the
    columns it wants, its ranges in order."""
    group, m, r = mesh.group("model"), mesh.sizes["model"], mesh.coords["model"]
    out = {}
    for name, (wants, cols) in EXCHANGES.items():
        whole = torch.arange(3 * cols * m, dtype=torch.float64).reshape(3, cols * m)
        got = CL.fetch_columns(whole[:, r * cols:(r + 1) * cols], wants, group, mesh=mesh)
        want = torch.cat([whole[:, a:b] for a, b in wants[r]], dim=-1)
        out[name] = (got.numpy(), want.numpy())
    return out


def run_rank(rank, group, layout, inputs):
    torch.set_num_threads(1)
    flat = {}
    for path in inputs:
        with np.load(path) as f:
            flat.update(f)
    meshes = {shape: LM.make_mesh(shape, AXES, device="cpu")
              for shape in sorted({s for _, s in RUNS.values()})}
    out = {"coords": {shape: m.coords for shape, m in meshes.items()},
           "forward": {f"{run}{SEP}{mode}": forward(run, flat, meshes[RUNS[run][1]],
                                                     seq_parallel=sp)
                       for run in RUNS for mode, sp in MODES.items()},
           "decode": {run: decode(run, flat, meshes[RUNS[run][1]]) for run in RUNS},
           "faults": faults(flat, meshes),
           "adjoints": adjoints(meshes[(2, 4)]),
           "exchanged": exchanged(meshes[(2, 4)])}
    with step_cases() as TSH:
        out["step"] = {name: TSH.run_case(name, flat, rank, STEPS[name]) for name in STEP_CASES}
    return out


# ------------------------------------- the JAX side: this file as a script
def _jax():
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax

    assert jax.device_count() >= 8, jax.devices()
    return jax


def _save(path, flat):
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def _named(jax, mesh, tree):
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.tree.map(lambda sp: NamedSharding(mesh, sp), tree,
                        is_leaf=lambda x: isinstance(x, P))


def jax_forward(out: str, inputs: str) -> None:
    """The parameters and tokens of both archs to ``inputs``, then each
    run's jitted forward and loss under the rules' shardings, with and
    without ``seq_parallel``."""
    jax = _jax()
    from jax.sharding import Mesh

    from repro.configs import get_smoke_config as j_smoke
    from repro.dist import sharding as JSH
    from repro.models import model as JM

    init = {arch: JM.init_params(jax.random.key(0), j_smoke(arch)) for arch in ARCHS}
    flat = {}
    for arch, p in init.items():
        flatten(jax.tree.map(np.asarray, p), f"params{SEP}{arch}", flat)
        flat[f"tokens{SEP}{arch}"] = tokens(j_smoke(arch).vocab, (ROWS, SEQ))
    _save(inputs, flat)

    results = {}
    for run, (arch, shape) in RUNS.items():
        cfg = j_smoke(arch)
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape), AXES)
        for mode, sp in MODES.items():
            JSH.set_active(JSH.ShardRules(seq_parallel=sp), mesh)
            rules = JSH.active()[0]
            specs = _named(jax, mesh, JM.param_specs(cfg, rules))
            bspec = _named(jax, mesh, {"tokens": rules.tokens(), "labels": rules.tokens()})

            def fwd(p, b):
                logits, _, _ = JM.forward_train(p, b, cfg, use_kernel=False)
                loss, metrics = JM.loss_fn(p, b, cfg, use_kernel=False)
                return logits, loss, metrics["ce"]

            t = flat[f"tokens{SEP}{arch}"]
            batch = jax.device_put({"tokens": t, "labels": t}, bspec)
            vals = jax.jit(fwd, in_shardings=(specs, bspec))(jax.device_put(init[arch], specs),
                                                             batch)
            for key, val in zip(("logits", "loss", "ce"), vals):
                results[f"{run}{SEP}{mode}{SEP}{key}"] = np.asarray(val)
            JSH.clear_active()
    np.savez(out, **results)


def jax_decode(out: str, inputs: str) -> None:
    """Each arch's filled cache and tokens to ``inputs`` (the parameters are
    ``jax_forward``'s, the same key), then each run's two decode steps
    through the reference's jit under ``param_specs`` and ``cache_specs``:
    the logits and the new cache."""
    jax = _jax()
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.configs import get_smoke_config as j_smoke
    from repro.dist import sharding as JSH
    from repro.models import model as JM

    rng = np.random.default_rng(5)
    made, flat = {}, {}
    for arch in ARCHS:
        cfg = j_smoke(arch)
        params = JM.init_params(jax.random.key(0), cfg)
        cache = jax.tree.map(lambda a: (0.5 * rng.standard_normal(a.shape)).astype(np.float32),
                             JM.init_cache(cfg, B, MAX_SEQ, jnp.float32))
        toks = tokens(cfg.vocab, (2, B))
        made[arch] = params, cache, toks
        flatten(cache, f"cache{SEP}{arch}", flat)
        flat[f"dtokens{SEP}{arch}"] = toks
    _save(inputs, flat)

    results = {}
    for run, (arch, shape) in RUNS.items():
        cfg = j_smoke(arch)
        params, cache, toks = made[arch]
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape), AXES)
        JSH.set_active(JSH.ShardRules(), mesh)
        rules = JSH.active()[0]
        pspecs = _named(jax, mesh, JM.param_specs(cfg, rules))
        cspecs = _named(jax, mesh, JM.cache_specs(cfg, rules, False))
        rows = NamedSharding(mesh, P(rules.batch_axes))
        out_sh = (NamedSharding(mesh, P(rules.batch_axes, None)), cspecs)
        p = jax.device_put(params, pspecs)
        c = jax.device_put(cache, cspecs)
        for step, pos in enumerate(POS):
            fn = jax.jit(lambda p, c, b, pos=pos: JM.decode_step(p, c, b, pos, cfg),
                         in_shardings=(pspecs, cspecs, {"token": rows}), out_shardings=out_sh)
            logits, c = fn(p, c, {"token": jax.device_put(toks[step], rows)})
            results[f"{run}{SEP}logits{SEP}{step}"] = np.asarray(logits)
        flatten(jax.tree.map(np.asarray, c), f"{run}{SEP}cache", results)
        JSH.clear_active()
    np.savez(out, **results)


def jax_step(out: str, inputs: str) -> None:
    """``STEPS`` steps of the reference's sharded jit of each ``STEP_CASES``
    case (``tests/test_torch_train_sharded.py``'s ``jax_main``), the
    parameters and tokens to ``inputs`` first."""
    _jax()
    flat = {}
    with step_cases() as TSH:
        for i, name in enumerate(STEP_CASES):
            with patched(TSH, "STEPS", STEPS[name]):
                TSH.jax_main(f"{out}.{name}.npz", inputs if i == 0 else "-", [name])
            with np.load(f"{out}.{name}.npz") as f:
                flat.update(f)
    np.savez(out, **flat)


if __name__ == "__main__":
    {"forward": jax_forward, "decode": jax_decode, "step": jax_step}[sys.argv[1]](*sys.argv[2:4])


# ------------------------------------------------------------------ tests
SIDES = ("forward", "decode", "step")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(per-rank results, the reference's results by key, the step cases'
    inputs): the three JAX subprocesses start first and write the inputs,
    and the 8 gloo ranks run beside them once those are there."""
    root = tmp_path_factory.mktemp("recurrent_tp")
    path = os.pathsep.join([str(SRC), str(TESTS), os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=path)
    inputs = {side: root / f"in_{side}.npz" for side in SIDES}
    procs = {side: subprocess.Popen(
        [sys.executable, __file__, side, str(root / f"out_{side}.npz"), str(inputs[side])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for side in SIDES}
    try:
        for side in SIDES:
            wait_for(inputs[side], procs[side])
        ranks = LM.spawn(run_rank, 8, device="cpu",
                         args=([str(inputs[side]) for side in SIDES],))
    finally:
        logs = {side: proc.communicate(timeout=900)[0] for side, proc in procs.items()}
    ref = {}
    for side, proc in procs.items():
        assert proc.returncode == 0, logs[side][-6000:]
        with np.load(root / f"out_{side}.npz") as f:
            ref.update(f)
    return ranks, ref


def whole_rows(ranks, run, get):
    """The whole batch of a per-rank array: each data shard from its model
    group's first rank."""
    n_data, n_model = RUNS[run][1]
    return np.concatenate([get(ranks[dc * n_model]) for dc in range(n_data)])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("run", list(RUNS))
def test_forward_matches_the_reference_jit(runs, run, mode):
    """Each data shard's logits, gathered over the vocabulary, within
    MODEL_TOL of the reference's jitted forward under the same rules, on
    the rank's cut mixer leaves; every rank of a model group holds the
    same logits."""
    ranks, ref = runs
    key = f"{run}{SEP}{mode}"
    got = whole_rows(ranks, run, lambda r: r["forward"][key]["logits"])
    close(got, ref[f"{key}{SEP}logits"], MODEL_TOL)
    n_model = RUNS[run][1][1]
    for r, res in enumerate(ranks):
        assert_bits(res["forward"][key]["logits"], ranks[r - r % n_model]["forward"][key]["logits"])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("run", list(RUNS))
def test_loss_matches_the_reference_jit(runs, run, mode):
    """The loss and ``ce`` (the mean over the data shards) within MODEL_TOL
    of the reference's."""
    ranks, ref = runs
    key = f"{run}{SEP}{mode}"
    n_data, n_model = RUNS[run][1]
    for what in ("loss", "ce"):
        got = np.mean([ranks[dc * n_model]["forward"][key][what] for dc in range(n_data)])
        close(got, ref[f"{key}{SEP}{what}"], MODEL_TOL)


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("run", list(RUNS))
def test_decode_matches_the_reference_jit(runs, run, step):
    """Each data shard's logits, every vocabulary entry, within MODEL_TOL of
    the reference's jitted decode, the recurrent states at their shards;
    every rank of a model group holds the same logits."""
    ranks, ref = runs
    got = whole_rows(ranks, run, lambda r: r["decode"][run]["logits"][step])
    assert np.isfinite(got).all()
    close(got, ref[f"{run}{SEP}logits{SEP}{step}"], MODEL_TOL)
    n_model = RUNS[run][1][1]
    for r, res in enumerate(ranks):
        assert_bits(res["decode"][run]["logits"][step],
                    ranks[r - r % n_model]["decode"][run]["logits"][step])


@pytest.mark.parametrize("run", list(RUNS))
def test_state_shards_match_the_reference(runs, run):
    """After both steps each rank's shard of every recurrent state (Mamba's
    ``conv`` and ``ssm`` on d_inner, the mLSTM's ``C`` and ``n`` on the key
    dim and ``m`` whole, the sLSTM's on d; and Jamba's attention cache on
    the sequence) is the same shard of the reference's new cache, within
    CACHE_TOL."""
    ranks, ref = runs
    arch, shape = RUNS[run]
    cfg = get_smoke_config(arch)
    want = port_cache(ref, f"{run}{SEP}cache", cfg)
    cspecs = TM.cache_specs(cfg, SH.ShardRules(), False)
    sizes = dict(zip(AXES, shape))
    for res in ranks:
        got = res["decode"][run]["cache"]
        for path, whole in O.flatten(want):
            block = shard_of(whole, O.get(cspecs, path), res["coords"][shape], sizes)
            assert got[SEP.join(map(str, path))].shape == tuple(block.shape), path
            close(got[SEP.join(map(str, path))], block.numpy(), CACHE_TOL)


def test_jamba_sharded_step_matches_the_reference_jit(runs):
    """Jamba smoke's two sharded steps with FSDP on (2, 4), the Mamba mixers
    on their cut leaves, gathered: every leaf of the parameters and the
    optimizer state within MODEL_TOL of the reference's sharded jit, loss
    and grad_norm within LOSS_TOL at each step, on every rank
    (``tests/test_torch_train_sharded.py``'s check)."""
    ranks, ref = runs
    with step_cases() as TSH:
        TSH.assert_matches_reference(ref, "jamba", [r["step"]["jamba"] for r in ranks])


def test_xlstm_sharded_step_matches_the_reference_jit(runs):
    """xLSTM smoke's sharded step with FSDP on (2, 4), the mLSTM and sLSTM
    mixers on their cut leaves, gathered: the first moment of every leaf
    (0.1 of its clipped gradient) within MODEL_TOL of the reference's
    sharded jit after one step, loss and grad_norm within LOSS_TOL, on
    every rank. Parameters are not compared after Adam's first step, which
    moves each by about lr·sign(g) (``STEPS``)."""
    ranks, ref = runs
    with step_cases() as TSH:
        results = [r["step"]["xlstm"] for r in ranks]
        _, want_s = TSH.reference_state(ref, "xlstm")
        got_s = TSH.unflat(results[0]["state"], "opt")
        assert int(got_s["step"]) == int(want_s["step"]) == STEPS["xlstm"]

        def moments(mu):
            return {path[:-1]: x for path, x in O.flatten(mu) if path[-1] == "m"}

        TSH.assert_tree_close(moments(got_s["mu"]), moments(TSH._numpy(want_s["mu"])),
                              MODEL_TOL, "first moment")
        for res in results:
            for k in ("loss", "grad_norm"):
                want = float(ref[f"xlstm{SEP}metrics{SEP}0{SEP}{k}"])
                assert abs(res["metrics"][0][k] - want) <= TSH.LOSS_TOL * abs(want), (k, want)


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_fails(runs, fault):
    """A planted fault: the stored ``w_in`` columns taken as the x and z of
    the rank's channels (no exchange), the sLSTM step on the rank's own
    ``h`` (no gather), the mLSTM's output norm on the rank's own sum of
    squares (no sum over the axis). Each leaves MODEL_TOL of the
    reference's logits."""
    ranks, ref = runs
    run = FAULTS[fault]
    got = whole_rows(ranks, run, lambda r: r["faults"][fault]["logits"])
    with pytest.raises(AssertionError):
        close(got, ref[f"{run}{SEP}tp{SEP}logits"], MODEL_TOL)


@pytest.mark.parametrize("op", list(EXCHANGES) + ["gather_last"])
def test_pair_adjoints(runs, op):
    """<A x, y> = <x, Aᵀ y> summed over the 8 ranks, in float64: the
    fetch's backward is the reverse exchange summed into the columns
    (a column fetched by two ranks gets both cotangents), the gather's the
    rank's block of the summed cotangents."""
    ranks, _ = runs
    lhs = sum(r["adjoints"][op][0] for r in ranks)
    rhs = sum(r["adjoints"][op][1] for r in ranks)
    assert abs(lhs - rhs) <= ADJOINT_TOL * max(1.0, abs(lhs)), (op, lhs, rhs)


@pytest.mark.parametrize("case", list(EXCHANGES))
def test_part_exchange_gives_each_rank_its_channels(runs, case):
    """On every rank the fetch from its stored block gives the columns it
    wants (its channel block of every part, or an mLSTM head's x columns
    and its gate block), bit for bit."""
    ranks, _ = runs
    for r in ranks:
        got, want = r["exchanged"][case]
        assert_bits(got, want)


#: (parts, whole columns, ranks)
PLANS = [(2, 256, 16), (4, 8192, 16), (2, 8192, 16), (4, 256, 4), (2, 64, 8), (4, 32, 2)]


@pytest.mark.parametrize("parts,whole,n", PLANS, ids=[f"{p}x{w}-n{n}" for p, w, n in PLANS])
def test_part_plan_is_a_permutation(parts, whole, n):
    """Over all ranks the plan of ``part_wants`` moves every column once, to
    the rank of its channel block, each rank receiving as many columns as
    it sends and in ``[part 0 | part 1 | …]`` order."""
    blk, W = whole // n, whole // parts
    got = {r: [] for r in range(n)}
    wants = CL.part_wants(parts, whole, n)
    plans = [CL.fetch_plan(wants, whole, r) for r in range(n)]
    for j, (order, send, _) in enumerate(plans):
        assert sorted(order) == list(range(blk))
        at = 0
        for r, count in enumerate(send):
            got[r].append([j * blk + col for col in order[at:at + count]])
            at += count
    for r, (_, send, recv) in enumerate(plans):
        assert sum(send) == sum(recv) == blk
        assert [len(cols) for cols in got[r]] == list(recv)
        cols = [c for part in got[r] for c in part]
        assert cols == [p * W + r * W // n + i for p in range(parts) for i in range(W // n)]


class _Mesh:
    """A rank's view of a (1, 4) mesh with no process groups: the leaf
    checks run before any collective."""
    axis_names, shape, rank = AXES, (1, 4), 1
    sizes = {"data": 1, "model": 4}
    coords = {"data": 0, "model": 1}


MIXER_LEAVES = [(JAMBA, 1, k) for k in ("w_in", "conv_w", "w_bcdt", "A_log", "w_out")] + \
    [(XLSTM, 0, k) for k in ("w_up", "w_if", "w_down")] + \
    [(XLSTM, 7, k) for k in ("w_gates", "r_gates", "b_gates", "w_out")]


@pytest.mark.parametrize("arch,layer,leaf", MIXER_LEAVES)
def test_a_whole_mixer_leaf_raises(arch, layer, leaf):
    """Under the tensor axis a Mamba, mLSTM or sLSTM leaf of its whole
    shape, where the rank's cut is due, raises ``ValueError`` naming it, in
    the train form and in the decode; nothing gathers or falls back."""
    cfg = get_smoke_config(arch)
    whole = TM.init_params(0, cfg, device="cpu")
    rules = SH.ShardRules(model_axis_size=4, data_axis_size=1)
    lp = TM.local_params(whole, cfg, rules, _Mesh.coords, _Mesh.sizes)
    tp = CL.TensorParallel(rules, _Mesh)
    mixer = dict(lp["stack"][layer]["mixer"], **{leaf: whole["stack"][layer]["mixer"][leaf]})
    kind = cfg.layer_kinds()[layer][0]
    train, dec = {"mamba": (MB.mamba_train, MB.mamba_decode),
                  "mlstm": (XL.mlstm_train, XL.mlstm_decode),
                  "slstm": (XL.slstm_train, XL.slstm_decode)}[kind]
    cspecs = TM.cache_specs(cfg, rules, False)["stack"][layer]
    state = TM.init_cache(cfg, 1, 8, torch.float32, device="cpu")["stack"][layer]
    state = {k: shard_of(v, cspecs[k], _Mesh.coords, _Mesh.sizes) for k, v in state.items()}
    with pytest.raises(ValueError, match=f"^{leaf} "):
        train(mixer, torch.zeros((1, 8, cfg.d_model)), cfg, tp=tp)
    with pytest.raises(ValueError, match=f"^{leaf} "):
        dec(mixer, torch.zeros((1, 1, cfg.d_model)), state, cfg, tp=tp)


def test_xlstm_decode_cell_moves_no_state_bytes():
    """xLSTM smoke's decode cell on rank 0 of a fake (2, 4) world, 8 rows a
    rank: its collectives carry, by hand count, each mLSTM layer's
    all-to-all of the new token's ``[x | gate]`` products (every head's x
    columns and the rank's gate block), the sum of its i and f partials,
    the joined q·C and q·n and its row sum; the sLSTM's all-gather of
    ``h``, its one all-to-all of the gates and its row sum; then the
    embedding's and the logits' all-gathers: the same bytes at a cache of
    32 and of 1024 positions, none of them a state's."""
    from repro_torch.launch import dryrun as D

    cfg = get_smoke_config(XLSTM)
    rules = SH.ShardRules(data_axis_size=2, model_axis_size=4)
    Bl, H, d, V, m = 8, cfg.n_heads, cfg.d_model, cfg.vocab, 4
    dp = int(cfg.xlstm.proj_factor_mlstm * d)
    kinds = [k for k, _ in cfg.layer_kinds()] * cfg.n_groups
    n_m, n_s = kinds.count("mlstm"), kinds.count("slstm")
    f32 = 4
    gather = (n_s * Bl * d + Bl * d + Bl * V) * f32
    reduce = (n_m * (Bl * 2 * H + Bl * H * (dp // H + 1) + Bl * d) + n_s * Bl * d) * f32
    want = {"all-gather": float(gather), "all-reduce": float(reduce),
            "all-to-all": float((n_m * Bl * (dp + dp // m) + n_s * Bl * 4 * d // m) * f32),
            "_counts": {"all-gather": n_s + 2, "all-reduce": 3 * n_m + n_s,
                        "all-to-all": n_m + n_s}}
    for seq in (32, 1024):
        trace = D.trace_cell(cfg, ShapeConfig("smoke", seq, Bl * 2, "decode"), rules, 1)
        got = D.run_trace(trace, rules, (2, 4), AXES, 0)
        assert got["collectives"] == want, (seq, got["collectives"], want)
