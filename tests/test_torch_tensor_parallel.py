"""The tensor-parallel train path (``models.forward_train`` and ``loss_fn``
under active rules on the rank's compute leaves, ``models.local_params``)
and its tensor-axis collectives (``dist.collectives.tp_sum``,
``seq_gather``, ``seq_scatter_sum``), against the JAX package.

Eight gloo ranks on the CPU (spawned once for the module through
``repro_torch.launch.mesh.spawn``) lay themselves out as a (2, 4) (data,
model) mesh and run TinyLlama, Mixtral and DeepSeek smoke's forward and
loss on their data shard, with and without ``seq_parallel``, each rank
on its heads, ff slice and vocabulary slice (TinyLlama's 2 KV heads and
Mixtral's do not split over 4: the rank takes the KV head its query head
reads). The JAX side runs this file as a script on 8 forced host
devices, in two subprocesses started beside the ranks:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/test_torch_tensor_parallel.py OUT.npz PARAMS.npz SEQ_PARALLEL

each the reference's ``jax.jit`` of ``forward_train`` and ``loss_fn``
with the parameters under ``param_specs``' shardings and the batch under
the rules' token spec, ``seq_parallel`` as given; the first writes the
parameters (``jax.random.key(0)``) and the tokens first, which the ranks
wait for.

Tolerances: the logits (gathered over the vocabulary), the loss, ``ce``
and the aux within ``MODEL_TOL`` (1e-4) of the reference's; the pairs'
adjoints and the vocabulary-parallel cross entropy (value and gradient,
against the whole one) in float64 within ``ADJOINT_TOL`` (1e-12). A
planted fault that must fail: the wrong KV head taken (the forward leaves
the tolerance). A column block's input is the identity both ways; the
faults of the sums its copies' cotangents meet (a row block's, the
sequence gather's) are planted in the sharded step, against the
reference's jit (``tests/test_torch_train_sharded.py``).
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.dist import collectives as CL
from repro_torch.dist import sharding as SH
from repro_torch.launch import mesh as LM
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax

from test_torch_moe_ep import SEP, assert_bits, close, flatten, unflatten, wait_for

TESTS = pathlib.Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
MODEL_TOL = 1e-4
ADJOINT_TOL = 1e-12
MESH = (2, 4)
AXES = ("data", "model")
ARCHS = ("tinyllama-1.1b", "mixtral-8x7b", "deepseek-v3-671b")
MODES = {"tp": False, "sp": True}  # name -> seq_parallel
ROWS, SEQ = 4, 16
PAIRS = ("tp_sum", "seq_gather", "seq_scatter_sum", "gather_cols")


def tokens(vocab):
    return np.random.default_rng(3).integers(1, vocab, (ROWS, SEQ)).astype(np.int32)


def data_rows(a, coords):
    step = a.shape[0] // MESH[0]
    return a[coords["data"] * step:(coords["data"] + 1) * step]


# ------------------------------------------------- the port's side: a rank
def forward_and_loss(params, batch, cfg):
    logits, aux, _ = TM.forward_train(params, batch, cfg, use_kernel=False)
    loss, metrics = TM.loss_fn(params, batch, cfg, use_kernel=False)
    return {"logits": TM.whole_logits(logits).detach().numpy(), "aux": aux.detach().numpy(),
            "loss": loss.detach().numpy(), "ce": metrics["ce"].detach().numpy()}


def models(rank, mesh, flat):
    out = {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        whole = params_from_jax(unflatten(flat, f"params{SEP}{arch}"), cfg, device="cpu")
        t = torch.from_numpy(data_rows(flat[f"tokens{SEP}{arch}"], mesh.coords)).long()
        for mode, sp in MODES.items():
            SH.set_active(SH.ShardRules(seq_parallel=sp), mesh)
            lp = TM.local_params(whole, cfg, SH.active()[0], mesh.coords, mesh.sizes)
            out[f"{arch}{SEP}{mode}"] = forward_and_loss(lp, {"tokens": t, "labels": t}, cfg)
            SH.clear_active()
    return out


def adjoints(mesh):
    """<A x, y> and <x, Aᵀ y> on this rank, float64, for each pair."""
    group = mesh.group("model")
    gen = torch.Generator().manual_seed(100 + mesh.rank)
    ops = {
        "tp_sum": lambda x: CL.tp_sum(x, group, mesh=mesh),
        "seq_gather": lambda x: CL.seq_gather(x, 1, group, mesh=mesh),
        "seq_scatter_sum": lambda x: CL.seq_scatter_sum(x, 1, group, mesh=mesh),
        "gather_cols": lambda x: CL.TensorParallel(SH.ShardRules(), mesh).gather_cols(x[0]),
    }
    out = {}
    for op, fn in ops.items():
        x = torch.randn((2, 8, 3), generator=gen, dtype=torch.float64).requires_grad_(True)
        ax = fn(x)
        y = torch.randn(ax.shape, generator=gen, dtype=torch.float64)
        (aty,) = torch.autograd.grad(ax, x, y)
        out[op] = (float((ax * y).sum()), float((x * aty).sum()))
    return out


def xent(mesh):
    """The vocabulary-parallel cross entropy (float64) on the rank's slice
    of logits the same on every rank of the model group, against the whole
    one: (its loss, the whole loss, its gradient seeded 1 / n_model, the
    whole gradient's slice)."""
    gen = torch.Generator().manual_seed(11 + mesh.coords["data"])
    m, c = mesh.sizes["model"], mesh.coords["model"]
    logits = 4 * torch.randn((3, 10, 8 * m), generator=gen, dtype=torch.float64)
    labels = torch.randint(0, 8 * m, (3, 10), generator=gen)
    whole = logits.clone().requires_grad_(True)
    want = TM.softmax_xent(whole, labels)
    (g_whole,) = torch.autograd.grad(want, whole)
    mine = logits[..., c * 8:(c + 1) * 8].clone().requires_grad_(True)
    SH.set_active(SH.ShardRules(), mesh)
    try:
        got = TM.softmax_xent(mine, labels, tp=CL.tensor_parallel())
        (g,) = torch.autograd.grad(got, mine, torch.tensor(1.0 / m, dtype=torch.float64))
    finally:
        SH.clear_active()
    return float(got), float(want), g.numpy(), g_whole[..., c * 8:(c + 1) * 8].numpy()


def kv_pick(mesh, flat):
    """TinyLlama smoke (2 KV heads over 4): the rank's ``wk`` and ``wv``
    columns of the KV heads its query heads read, against the whole
    leaf's."""
    cfg = get_smoke_config("tinyllama-1.1b")
    whole = params_from_jax(unflatten(flat, f"params{SEP}tinyllama-1.1b"), cfg, device="cpu")
    SH.set_active(SH.ShardRules(), mesh)
    try:
        tp = CL.tensor_parallel()
        lp = TM.local_params(whole, cfg, SH.active()[0], mesh.coords, mesh.sizes)
        h0, h1 = A.head_block(cfg.n_heads, tp.size, tp.coord)
        k0, k1, pick = A.kv_heads_read(cfg.n_heads, cfg.n_kv_heads, h0, h1)
        layer = lp["stack"][0]["mixer"]
        out = {"heads": (h0, h1, k0, k1, pick)}
        for key in ("wk", "wv"):
            got = A._heads(key, layer[key], cfg.n_kv_heads, cfg.head_dim, tp, k0, k1)
            want = whole["stack"][0]["mixer"][key][:, k0 * cfg.head_dim:k1 * cfg.head_dim]
            out[key] = (got.detach().numpy(), want.numpy())
    finally:
        SH.clear_active()
    return out


def wrong_kv(mesh, flat):
    """TinyLlama smoke's forward with a planted fault: each query head reads
    the KV head after its own."""
    real = A.kv_heads_read

    def shifted(H, Hkv, h0, h1):
        G = H // Hkv
        k0 = (h0 // G + 1) % Hkv
        return k0, k0 + 1, [0] * (h1 - h0)

    A.kv_heads_read = shifted
    try:
        arch = "tinyllama-1.1b"
        cfg = get_smoke_config(arch)
        whole = params_from_jax(unflatten(flat, f"params{SEP}{arch}"), cfg, device="cpu")
        t = torch.from_numpy(data_rows(flat[f"tokens{SEP}{arch}"], mesh.coords)).long()
        SH.set_active(SH.ShardRules(), mesh)
        lp = TM.local_params(whole, cfg, SH.active()[0], mesh.coords, mesh.sizes)
        return forward_and_loss(lp, {"tokens": t, "labels": t}, cfg)
    finally:
        A.kv_heads_read = real
        SH.clear_active()


def run_rank(rank, group, layout, params_path):
    torch.set_num_threads(1)
    with np.load(params_path) as f:
        flat = dict(f)
    mesh = LM.make_mesh(MESH, AXES, device="cpu")
    return {"coords": mesh.coords, "models": models(rank, mesh, flat),
            "adjoints": adjoints(mesh),
            "xent": xent(mesh), "kv_pick": kv_pick(mesh, flat),
            "wrong_kv": wrong_kv(mesh, flat)}


# ------------------------------------- the JAX side: this file as a script
def jax_main(out: str, params_out: str, seq_parallel: str) -> None:
    """The parameters and tokens of every arch to ``params_out`` (unless it
    is "-"), then each arch's jitted forward and loss under the rules'
    shardings on 8 forced host devices. Saved to ``out``."""
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.configs import get_smoke_config as j_smoke
    from repro.dist import sharding as JSH
    from repro.models import model as JM

    assert jax.device_count() >= 8, jax.devices()
    init = {arch: JM.init_params(jax.random.key(0), j_smoke(arch)) for arch in ARCHS}
    if params_out != "-":
        flat = {}
        for arch, p in init.items():
            flatten(jax.tree.map(np.asarray, p), f"params{SEP}{arch}", flat)
            flat[f"tokens{SEP}{arch}"] = tokens(j_smoke(arch).vocab)
        tmp = params_out + ".tmp.npz"
        np.savez(tmp, **flat)
        os.replace(tmp, params_out)

    results = {}
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(MESH), AXES)
    for arch in ARCHS:
        cfg = j_smoke(arch)
        JSH.set_active(JSH.ShardRules(seq_parallel=seq_parallel == "1"), mesh)
        rules = JSH.active()[0]

        def named(tree):
            return jax.tree.map(lambda sp: NamedSharding(mesh, sp), tree,
                                is_leaf=lambda x: isinstance(x, P))

        specs = named(JM.param_specs(cfg, rules))
        bspec = named({"tokens": rules.tokens(), "labels": rules.tokens()})

        def fwd(p, b):
            logits, aux, _ = JM.forward_train(p, b, cfg, use_kernel=False)
            loss, metrics = JM.loss_fn(p, b, cfg, use_kernel=False)
            return logits, aux, loss, metrics["ce"]

        t = tokens(cfg.vocab)
        batch = jax.device_put({"tokens": t, "labels": t}, bspec)
        p = jax.device_put(init[arch], specs)
        logits, aux, loss, ce = jax.jit(fwd, in_shardings=(specs, bspec))(p, batch)
        for key, val in (("logits", logits), ("aux", aux), ("loss", loss), ("ce", ce)):
            results[f"{arch}{SEP}{key}"] = np.asarray(val)
        JSH.clear_active()
    np.savez(out, **results)


if __name__ == "__main__":
    jax_main(*sys.argv[1:4])


# ------------------------------------------------------------------ tests
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(per-rank results, {mode: {key: JAX result}}): the two JAX
    subprocesses start first, one writes the parameters, and the 8 gloo
    ranks run beside them once those are there."""
    root = tmp_path_factory.mktemp("tensor_parallel")
    params = root / "params.npz"
    path = os.pathsep.join([str(SRC), str(TESTS), os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=path)
    procs = {mode: subprocess.Popen(
        [sys.executable, __file__, str(root / f"{mode}.npz"),
         str(params) if mode == "tp" else "-", "1" if sp else "0"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for mode, sp in MODES.items()}
    try:
        wait_for(params, procs["tp"])
        ranks = LM.spawn(run_rank, 8, device="cpu", args=(str(params),))
    finally:
        logs = {mode: proc.communicate(timeout=900)[0] for mode, proc in procs.items()}
    ref = {}
    for mode, proc in procs.items():
        assert proc.returncode == 0, logs[mode][-6000:]
        with np.load(root / f"{mode}.npz") as f:
            ref[mode] = dict(f)
    return ranks, ref


def _rows(ranks, key, what):
    """The whole batch's ``what``: each data shard from its model group's
    first rank."""
    return np.concatenate([ranks[dc * MESH[1]]["models"][key][what] for dc in range(MESH[0])])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_the_reference_jit(runs, arch, mode):
    """Each data shard's logits, gathered over the vocabulary, within
    MODEL_TOL of the reference's jitted forward under the same rules; every
    rank of a model group holds the same logits."""
    ranks, ref = runs
    key = f"{arch}{SEP}{mode}"
    close(_rows(ranks, key, "logits"), ref[mode][f"{arch}{SEP}logits"], MODEL_TOL)
    for r, res in enumerate(ranks):
        assert_bits(res["models"][key]["logits"], ranks[r - r % MESH[1]]["models"][key]["logits"])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_the_reference_jit(runs, arch, mode):
    """The loss and ``ce`` (the mean over the data shards, each over its own
    tokens) and the aux within MODEL_TOL of the reference's, the same on
    every rank of a model group."""
    ranks, ref = runs
    key = f"{arch}{SEP}{mode}"
    for what in ("loss", "ce"):
        got = np.mean([ranks[dc * MESH[1]]["models"][key][what] for dc in range(MESH[0])])
        close(got, ref[mode][f"{arch}{SEP}{what}"], MODEL_TOL)
    for res in ranks:
        close(res["models"][key]["aux"], ref[mode][f"{arch}{SEP}aux"], MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_seq_parallel_is_the_same_forward(runs, arch):
    """``seq_parallel`` cuts the residual stream, not the function: its
    logits within MODEL_TOL of the plain rules' on every rank."""
    ranks, _ = runs
    for res in ranks:
        close(res["models"][f"{arch}{SEP}sp"]["logits"], res["models"][f"{arch}{SEP}tp"]["logits"],
              MODEL_TOL)


@pytest.mark.parametrize("op", PAIRS)
def test_pair_adjoints(runs, op):
    """<A x, y> = <x, Aᵀ y> summed over the 8 ranks, in float64."""
    ranks, _ = runs
    lhs = sum(r["adjoints"][op][0] for r in ranks)
    rhs = sum(r["adjoints"][op][1] for r in ranks)
    assert abs(lhs - rhs) <= ADJOINT_TOL * max(1.0, abs(lhs)), (op, lhs, rhs)


def test_vocab_parallel_xent_is_the_whole_one(runs):
    """On every rank, the cross entropy of its vocabulary slice equals the
    whole logits' (float64, ADJOINT_TOL), and its gradient, seeded
    1 / n_model, the whole gradient's slice."""
    ranks, _ = runs
    for r in ranks:
        got, want, g, g_whole = r["xent"]
        assert abs(got - want) <= ADJOINT_TOL * abs(want), (got, want)
        np.testing.assert_allclose(g, g_whole, rtol=0, atol=ADJOINT_TOL)


def test_kv_pick_at_two_kv_heads_over_four(runs):
    """TinyLlama smoke, 4 query and 2 KV heads over model 4: rank c computes
    query head c and reads KV head c // 2, whose ``wk`` and ``wv`` columns,
    gathered over the axis, are the whole leaf's bit for bit."""
    ranks, _ = runs
    for r in ranks:
        c = r["coords"]["model"]
        assert r["kv_pick"]["heads"] == (c, c + 1, c // 2, c // 2 + 1, [0])
        for key in ("wk", "wv"):
            got, want = r["kv_pick"][key]
            assert_bits(got, want)


def test_planted_wrong_kv_head_fails(runs):
    """A planted fault: each query head reads the KV head after its own. The
    logits leave MODEL_TOL of the reference's."""
    ranks, ref = runs
    arch = "tinyllama-1.1b"
    got = np.concatenate([ranks[dc * MESH[1]]["wrong_kv"]["logits"] for dc in range(MESH[0])])
    with pytest.raises(AssertionError):
        close(got, ref["tp"][f"{arch}{SEP}logits"], MODEL_TOL)


#: (query heads, KV heads, model axis)
HEAD_CASES = [(4, 2, 4), (4, 2, 8), (32, 4, 16), (32, 4, 2), (32, 8, 16), (28, 4, 16),
              (128, 128, 16), (64, 8, 16), (8, 2, 4), (4, 4, 8), (16, 16, 16)]


@pytest.mark.parametrize("H,Hkv,m", HEAD_CASES, ids=[f"{h}q{k}kv-m{m}" for h, k, m in HEAD_CASES])
def test_head_blocks_and_kv_heads(H, Hkv, m):
    """Each rank's head block covers exactly the heads its columns touch
    (the blocks cover every head; H / m each where the heads split), and
    the KV heads it reads are those of its query heads (h // (H / Hkv)),
    each query head's pick within them."""
    seen = set()
    for c in range(m):
        h0, h1 = A.head_block(H, m, c)
        cols = range(c * H * 4 // m, (c + 1) * H * 4 // m)  # 4 columns a head
        assert {j // 4 for j in cols} == set(range(h0, h1))
        seen |= set(range(h0, h1))
        if H % m == 0:
            assert h1 - h0 == H // m
        k0, k1, pick = A.kv_heads_read(H, Hkv, h0, h1)
        assert [k0 + p for p in pick] == [h // (H // Hkv) for h in range(h0, h1)]
        assert set(pick) == set(range(k1 - k0))
    assert seen == set(range(H))


class _Mesh:
    """A rank's view of a (1, 4) mesh with no process groups: the leaf
    checks run before any collective."""
    axis_names, shape, rank = AXES, (1, 4), 1
    sizes = {"data": 1, "model": 4}
    coords = {"data": 0, "model": 1}


#: (arch, layer, mixer leaf) of the recurrent mixers' concatenated leaves
RECURRENT_LEAVES = {"mamba/w_in": ("jamba-1.5-large-398b", 1, "w_in"),
                    "mlstm/w_up": ("xlstm-1.3b", 0, "w_up"),
                    "slstm/w_gates": ("xlstm-1.3b", 7, "w_gates"),
                    "slstm/r_gates": ("xlstm-1.3b", 7, "r_gates")}


@pytest.mark.parametrize("leaf", ["wq", "wk", "wo", "w_in", "w_gate", "w_out", "table",
                                  "unembed", *RECURRENT_LEAVES])
def test_a_whole_leaf_raises(leaf):
    """Under the tensor axis a dense or mixer leaf of its whole shape, where
    the rank's cut is due, raises ``ValueError`` naming it; nothing falls
    back. The recurrent mixers' concatenated leaves (Mamba's ``[x | z]``
    ``w_in``, the mLSTM's ``[x | gate]`` ``w_up``, the sLSTM's ``[i | f |
    z | o]`` ``w_gates`` and ``r_gates``) included."""
    arch, at, name = RECURRENT_LEAVES.get(leaf, ("tinyllama-1.1b", 0, leaf))
    cfg = get_smoke_config(arch)
    whole = TM.init_params(0, cfg, device="cpu")
    rules = SH.ShardRules(model_axis_size=4, data_axis_size=1)
    lp = TM.local_params(whole, cfg, rules, _Mesh.coords, _Mesh.sizes)
    tp = CL.TensorParallel(rules, _Mesh)
    x = torch.zeros((1, 8, cfg.d_model))
    pos = torch.arange(8).expand(1, 8)
    layer = whole["stack"][at]
    if leaf in RECURRENT_LEAVES:
        from repro_torch.models import transformer as T

        kind = cfg.layer_kinds()[at][0]
        mixer = dict(lp["stack"][at]["mixer"], **{name: layer["mixer"][name]})
        call = lambda: T._RECURRENT[kind][1](mixer, x, cfg, tp=tp)  # noqa: E731
    elif leaf in ("wq", "wk", "wo"):
        mixer = dict(lp["stack"][0]["mixer"], **{leaf: layer["mixer"][leaf]})
        call = lambda: A.gqa_train(mixer, x, cfg, pos, use_kernel=False, tp=tp)  # noqa: E731
    elif leaf.startswith("w_"):
        ffn = dict(lp["stack"][0]["ffn"], **{leaf: layer["ffn"][leaf]})
        call = lambda: L.mlp_apply(ffn, x, tp=tp, ff=cfg.d_ff)  # noqa: E731
    elif leaf == "table":
        call = lambda: L.embed_apply(whole["embed"], torch.zeros((1, 8), dtype=torch.long),  # noqa: E731
                                     tp, cfg.d_model)
    else:
        call = lambda: TM._unembed(dict(lp, unembed=whole["unembed"]), x, cfg, tp)  # noqa: E731
    with pytest.raises(ValueError, match=name if leaf != "unembed" else "unembed/w"):
        call()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_compute_specs_keep_the_dense_cuts(arch):
    """At full width on the production axes, every leaf's compute spec is
    ``param_specs``' with its entries other than the tensor axis dropped,
    and the tensor axis dropped too where the leaf is computed whole (the
    final norm, the MTP projection and norm; a member's norms, router,
    MLA's ``wq_a`` and ``wkv_a`` and the mLSTM's block-diagonal ``wq``,
    ``wk`` and ``wv`` have no tensor entry to keep). Every attention
    member's ``wo``, every dense MLP's ``w_out`` and every Mamba, mLSTM
    and sLSTM leaf keep their cut: the concatenated ``w_in``, ``w_up``,
    ``w_gates`` and ``r_gates`` by columns, ``w_out`` and ``w_down`` by
    rows."""
    cfg = get_config(arch)
    rules = SH.ShardRules(fsdp=True)
    cspecs, pspecs = TM.compute_specs(cfg, rules), TM.param_specs(cfg, rules)
    kinds = cfg.layer_kinds() * cfg.n_groups

    def walk(c, p, path=()):
        if isinstance(p, dict):
            for k in p:
                walk(c[k], p[k], path + (k,))
        elif isinstance(p, list):
            for i, (ci, pi) in enumerate(zip(c, p)):
                walk(ci, pi, path + (i,))
        else:
            assert len(c) == len(p), path
            assert all(e in (None, rules.tensor_axis) for e in c), (path, c)
            whole = path[-1] in ("wq_a", "wkv_a", "router", "scale", "bias", "proj")
            want = tuple(None if whole or e != rules.tensor_axis else e for e in p)
            assert tuple(c) == want, (path, c, p)

    walk(cspecs, pspecs)
    t = rules.tensor_axis
    cuts = {"mamba": {"w_in": (None, t), "w_bcdt": (t, None), "w_out": (t, None)},
            "mlstm": {"w_up": (None, t), "w_if": (t, None), "w_down": (t, None),
                      "wq": (None, None, None)},
            "slstm": {"w_gates": (None, t), "r_gates": (None, t), "b_gates": (t,),
                      "w_out": (t, None)}}
    for layer, (mixer, ffn) in zip(cspecs["stack"], kinds):
        if mixer == "attn":
            assert layer["mixer"]["wo"] == (t, None)
        for key, spec in cuts.get(mixer, {}).items():
            assert layer["mixer"][key] == spec, (mixer, key)
        if ffn == "mlp":
            assert layer["ffn"]["w_out"] == (t, None)


#: (query heads, KV heads) a rank hands K4 on the tensor-parallel paths
LOCAL_HEADS = [(1, 1), (2, 1), (4, 1), (8, 8), (16, 2)]


@pytest.mark.parametrize("hq,hkv", LOCAL_HEADS, ids=[f"{q}q{k}kv" for q, k in LOCAL_HEADS])
def test_k4_takes_the_local_heads(hq, hkv):
    """K4's entry (``gqa_attention(use_kernel=True)``: on the CPU its plain
    version) at a rank's head counts, against the materialising oracle,
    causal and windowed: query head h reads KV head h // (Hq / Hkv)."""
    from repro_torch.kernels.flash_attention.ops import gqa_attention

    gen = torch.Generator().manual_seed(hq * 10 + hkv)
    q = torch.randn((2, 96, hq, 64), generator=gen)
    k = torch.randn((2, 96, hkv, 64), generator=gen)
    v = torch.randn((2, 96, hkv, 64), generator=gen)
    for window in (None, 32):
        got = gqa_attention(q, k, v, causal=True, window=window, use_kernel=True)
        want = gqa_attention(q, k, v, causal=True, window=window, use_kernel=False)
        assert got.shape == (2, 96, hq, 64)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
