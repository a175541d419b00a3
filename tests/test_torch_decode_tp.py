"""The tensor-parallel decode (``models.decode_step`` under active rules
on the rank's compute leaves, each attention cache the rank's block of the
sequence) and its log-sum-exp join (``dist.collectives.lse_combine``),
against the JAX package.

Eight gloo ranks on the CPU (spawned once for the module through
``repro_torch.launch.mesh.spawn``) lay themselves out as a (2, 4) (data,
model) mesh. For TinyLlama smoke (2 KV heads over 4), Mixtral smoke
(window 32), DeepSeek smoke (MLA and its dense prefix) and Jamba smoke
(its attention and its Mamba mixers cut, each Mamba state at its
``cache_specs`` shard) each rank takes its data shard of a cache of ``MAX_SEQ`` 128 positions, a block of 32 a rank,
holding random values below ``FILL`` (100), and decodes two steps: one
at position 100 (Mixtral's window leaves ranks 0 and 1 no key), then one
at the per-row positions ``POS``, owned by every rank of the axis (a row
at 5 leaves ranks 1–3 no key). The JAX side runs this file as a script
on 8 forced host devices, in two subprocesses started beside the ranks:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/test_torch_decode_tp.py OUT.npz INPUTS.npz ARCH,ARCH

each the reference's ``jax.jit`` of ``decode_step`` with the parameters
under ``param_specs``' shardings and the cache under ``cache_specs``', as
its ``lower_decode`` sets them, on the same parameters
(``jax.random.key(0)``), caches and tokens, which it writes first and the
ranks wait for.

Tolerances: the logits within ``MODEL_TOL`` (1e-4) of the reference's;
each rank's block of every attention cache leaf, and its shard of every
recurrent state, within ``CACHE_TOL`` (1e-5) of the reference's new
cache (float32); the join of the ranks' partials in float64 within
``JOIN_TOL`` (1e-12) of the whole softmax. Planted faults that must
fail: the join without its exp(m − M) rescale, the new token written into
every rank's block, and the ``seq_parallel`` pair used in the decode.
The dry run's TinyLlama decode cell moves through its collectives only
the activations of a hand count, the same at any cache length.
"""

import contextlib
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
from repro_torch.models import attention as A
from repro_torch.models import model as TM
from repro_torch.models.convert import _unstack, params_from_jax
from repro_torch.train import optimizer as O

from test_torch_moe_ep import SEP, assert_bits, close, flatten, unflatten, wait_for

TESTS = pathlib.Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
MODEL_TOL = 1e-4
CACHE_TOL = 1e-5
JOIN_TOL = 1e-12
MESH = (2, 4)
AXES = ("data", "model")
#: the JAX subprocesses' shares of the archs
SIDES = (("tinyllama-1.1b", "mixtral-8x7b"), ("deepseek-v3-671b", "jamba-1.5-large-398b"))
ARCHS = tuple(a for side in SIDES for a in side)
B, MAX_SEQ, FILL = 8, 128, 100
#: step 2's positions: data shard 0's rows owned by model ranks 3, 0, 1, 2, shard 1's by 3, 1, 2, 3
POS = np.array([101, 5, 40, 70, 127, 33, 64, 96], np.int32)
ATTN_LEAVES = ("k", "v", "c_kv", "k_rope")
FAULTS = {"no_rescale": ("tinyllama-1.1b", "mixtral-8x7b"), "all_write": ("tinyllama-1.1b",),
          "seq_pair": ("tinyllama-1.1b",)}
JOIN_CASES = {"every_block": None, "block_1_unseen": slice(8, 16), "only_block_3": slice(0, 24)}


def rules_of(**kw):
    return SH.ShardRules(data_axis_size=MESH[0], model_axis_size=MESH[1], **kw)


def held(path, whole, cspecs, coords):
    """The rank's part of a whole cache leaf, cut by ``cache_specs``: an
    attention leaf its rows and its block of the sequence, a recurrent
    state its rows and its block of the inner or feature dim."""
    return whole[SH.local_slices(O.get(cspecs, path), whole.shape, coords,
                                 dict(zip(AXES, MESH)))]


def port_cache(flat, prefix, cfg):
    """The port's cache tree (one dict a layer) of a JAX cache in ``flat``."""
    return _unstack(unflatten(flat, prefix), cfg, lambda a: torch.tensor(np.asarray(a)))


# ------------------------------------------------- the port's side: a rank
def decode(arch, flat, mesh, **kw):
    """The two decode steps on this rank under ``rules_of(**kw)``: (logits
    of each step, the new cache's leaves by path)."""
    cfg = get_smoke_config(arch)
    whole = params_from_jax(unflatten(flat, f"params{SEP}{arch}"), cfg, device="cpu")
    cache = port_cache(flat, f"cache{SEP}{arch}", cfg)
    tokens = flat[f"tokens{SEP}{arch}"]
    SH.set_active(rules_of(**kw), mesh)
    try:
        rules = SH.active()[0]
        cspecs = TM.cache_specs(cfg, rules, False)
        lp = TM.local_params(whole, cfg, rules, mesh.coords, mesh.sizes)
        mine = O.unflatten(cache, [held(path, t, cspecs, mesh.coords).clone()
                                   for path, t in O.flatten(cache)])
        rows = slice(mesh.coords["data"] * B // MESH[0], (mesh.coords["data"] + 1) * B // MESH[0])
        logits = []
        with torch.no_grad():
            for step, pos in enumerate((FILL, torch.from_numpy(POS[rows]).long())):
                tok = torch.from_numpy(tokens[step, rows]).long()
                out, mine = TM.decode_step(lp, mine, {"token": tok}, pos, cfg)
                logits.append(out.numpy())
    finally:
        SH.clear_active()
    return {"logits": logits,
            "cache": {SEP.join(map(str, path)): t.numpy() for path, t in O.flatten(mine)}}


def no_rescale(o, m, l, tp):  # noqa: E741
    """The planted join: the ranks' partials added with no exp(m − M)."""
    both = tp.sum(torch.cat([o, l[..., None]], dim=-1))
    return both[..., :-1] / both[..., -1:]


def every_rank_writes(pos_b, S_loc, tp):
    """The planted write: every rank writes the new token into its block."""
    return pos_b % S_loc, torch.ones_like(pos_b, dtype=torch.bool)


class SeqPairReached(RuntimeError):
    pass


@contextlib.contextmanager
def patched(*plants):
    """(owner, name, value) each set for the block, restored after."""
    real = [getattr(owner, name) for owner, name, _ in plants]
    for owner, name, value in plants:
        setattr(owner, name, value)
    try:
        yield
    finally:
        for (owner, name, _), value in zip(plants, real):
            setattr(owner, name, value)


def seq_tripwire():
    """The sequence pair replaced by a raise on every rank: on one token a
    row its reduce-scatter gives the first rank the token and the others
    nothing, so they fail apart and the first waits on them."""
    def reached(*args, **kw):
        raise SeqPairReached("the decode reached the seq_parallel pair")

    return (CL, "seq_gather", reached), (CL, "seq_scatter_sum", reached)


def faults(flat, mesh):
    """Each planted fault's decode, or the error it raised (on every rank
    alike: the seq_parallel pair meets the tripwire)."""
    plants = {"no_rescale": ({}, (CL, "lse_combine", no_rescale)),
              "all_write": ({}, (A, "_owned", every_rank_writes)),
              "seq_pair": ({"seq_parallel": True}, (CL.TensorParallel, "for_decode",
                                                    lambda self: self), *seq_tripwire())}
    out = {}
    for name, (kw, *plant) in plants.items():
        with patched(*plant):
            for arch in FAULTS[name]:
                try:
                    out[f"{name}{SEP}{arch}"] = decode(arch, flat, mesh, **kw)
                except SeqPairReached as e:
                    out[f"{name}{SEP}{arch}"] = {"error": str(e)}
    return out


def join(mesh):
    """float64, a query's softmax over 32 keys, 8 a rank: ``lse_combine``
    of the rank's partial over its block against the whole softmax, with
    the masked keys of each case at the plain version's -1e30 fill."""
    gen = torch.Generator().manual_seed(7)  # the same scores on every rank
    s = 3 * torch.randn((3, 2, 32), generator=gen, dtype=torch.float64)
    v = torch.randn((3, 2, 32, 5), generator=gen, dtype=torch.float64)
    c = mesh.coords["model"]
    SH.set_active(rules_of(), mesh)
    out = {}
    try:
        tp = CL.tensor_parallel()
        for name, masked in JOIN_CASES.items():
            sm = s.clone()
            if masked is not None:
                sm[..., masked] = -1e30
            want = torch.einsum("abk,abke->abe", torch.softmax(sm, dim=-1), v)
            blk, vb = sm[..., c * 8:(c + 1) * 8], v[..., c * 8:(c + 1) * 8, :]
            m = blk.amax(dim=-1)
            p = torch.exp(blk - m[..., None])
            got = CL.lse_combine(torch.einsum("abk,abke->abe", p, vb), m, p.sum(dim=-1), tp)
            out[name] = (got.numpy(), want.numpy())
    finally:
        SH.clear_active()
    return out


def seq_parallel_decode(flat, mesh):
    """TinyLlama's decode under ``seq_parallel`` rules, the sequence pair
    behind the tripwire: the decode must not reach it."""
    with patched(*seq_tripwire()):
        return decode("tinyllama-1.1b", flat, mesh, seq_parallel=True)


def run_rank(rank, group, layout, inputs):
    torch.set_num_threads(1)
    flat = {}
    for path in inputs:
        with np.load(path) as f:
            flat.update(f)
    mesh = LM.make_mesh(MESH, AXES, device="cpu")
    return {"coords": mesh.coords,
            "decode": {arch: decode(arch, flat, mesh) for arch in ARCHS},
            "seq_parallel": seq_parallel_decode(flat, mesh),
            "faults": faults(flat, mesh), "join": join(mesh)}


# ------------------------------------- the JAX side: this file as a script
def jax_main(out: str, inputs: str, archs: str) -> None:
    """Each arch's parameters, filled cache and tokens to ``inputs``, then
    its two decode steps through the reference's jit under the rules'
    shardings on 8 forced host devices: the logits and the new cache, to
    ``out``."""
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.configs import get_smoke_config as j_smoke
    from repro.dist import sharding as JSH
    from repro.models import model as JM

    assert jax.device_count() >= 8, jax.devices()
    archs = archs.split(",")
    rng = np.random.default_rng(5)

    def fill(path, a):
        v = (0.5 * rng.standard_normal(a.shape)).astype(np.float32)
        if path[-1].key in ATTN_LEAVES:  # (..., S, ·): the sequence is the second last dim
            v[..., FILL:, :] = 0
        return v

    made, flat = {}, {}
    for arch in archs:
        cfg = j_smoke(arch)
        params = JM.init_params(jax.random.key(0), cfg)
        cache = jax.tree_util.tree_map_with_path(
            fill, JM.init_cache(cfg, B, MAX_SEQ, jnp.float32))
        tokens = np.random.default_rng(3).integers(1, cfg.vocab, (2, B)).astype(np.int32)
        made[arch] = params, cache, tokens
        flatten(jax.tree.map(np.asarray, params), f"params{SEP}{arch}", flat)
        flatten(cache, f"cache{SEP}{arch}", flat)
        flat[f"tokens{SEP}{arch}"] = tokens
    tmp = inputs + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, inputs)

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(MESH), AXES)
    results = {}
    for arch in archs:
        cfg = j_smoke(arch)
        params, cache, tokens = made[arch]
        JSH.set_active(JSH.ShardRules(), mesh)
        rules = JSH.active()[0]

        def named(tree):
            return jax.tree.map(lambda sp: NamedSharding(mesh, sp), tree,
                                is_leaf=lambda x: isinstance(x, P))

        pspecs = named(JM.param_specs(cfg, rules))
        cspecs = named(JM.cache_specs(cfg, rules, False))
        rows = NamedSharding(mesh, P(rules.batch_axes))
        out_sh = (NamedSharding(mesh, P(rules.batch_axes, None)), cspecs)
        first = jax.jit(lambda p, c, b: JM.decode_step(p, c, b, FILL, cfg),
                        in_shardings=(pspecs, cspecs, {"token": rows}), out_shardings=out_sh)
        second = jax.jit(lambda p, c, b, pos: JM.decode_step(p, c, b, pos, cfg),
                         in_shardings=(pspecs, cspecs, {"token": rows}, rows),
                         out_shardings=out_sh)
        p = jax.device_put(params, pspecs)
        c = jax.device_put(cache, cspecs)
        l1, c = first(p, c, {"token": jax.device_put(tokens[0], rows)})
        l2, c = second(p, c, {"token": jax.device_put(tokens[1], rows)},
                       jax.device_put(POS, rows))
        results[f"{arch}{SEP}logits{SEP}0"] = np.asarray(l1)
        results[f"{arch}{SEP}logits{SEP}1"] = np.asarray(l2)
        flatten(jax.tree.map(np.asarray, c), f"{arch}{SEP}cache", results)
        JSH.clear_active()
    np.savez(out, **results)


if __name__ == "__main__":
    jax_main(*sys.argv[1:4])


# ------------------------------------------------------------------ tests
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(per-rank results, the reference's results by key): the two JAX
    subprocesses start first and write the inputs, and the 8 gloo ranks
    run beside them once those are there."""
    root = tmp_path_factory.mktemp("decode_tp")
    path = os.pathsep.join([str(SRC), str(TESTS), os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=path)
    inputs = [root / f"inputs{i}.npz" for i in range(len(SIDES))]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(root / f"out{i}.npz"), str(inputs[i]), ",".join(side)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, side in enumerate(SIDES)]
    try:
        for path_i, proc in zip(inputs, procs):
            wait_for(path_i, proc)
        ranks = LM.spawn(run_rank, 8, device="cpu", args=([str(p) for p in inputs],))
    finally:
        logs = [proc.communicate(timeout=900)[0] for proc in procs]
    ref = {}
    for i, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, log[-6000:]
        with np.load(root / f"out{i}.npz") as f:
            ref.update(f)
    return ranks, ref


def whole_rows(ranks, get):
    """The whole batch of a per-rank array: each data shard from its model
    group's first rank."""
    return np.concatenate([get(ranks[dc * MESH[1]]) for dc in range(MESH[0])])


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_the_reference_jit(runs, arch, step):
    """Each data shard's logits, every vocabulary entry, within MODEL_TOL of
    the reference's jitted decode under the same rules; every rank of a
    model group holds the same logits, all finite (a rank that sees no key
    weighs nothing and adds no NaN)."""
    ranks, ref = runs
    got = whole_rows(ranks, lambda r: r["decode"][arch]["logits"][step])
    assert np.isfinite(got).all()
    close(got, ref[f"{arch}{SEP}logits{SEP}{step}"], MODEL_TOL)
    for r, res in enumerate(ranks):
        assert_bits(res["decode"][arch]["logits"][step],
                    ranks[r - r % MESH[1]]["decode"][arch]["logits"][step])


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_blocks_match_the_reference(runs, arch):
    """After both steps each rank's block of every attention cache leaf (its
    rows, its 32 positions) is the reference's new cache's, and its shard
    of every recurrent state too, within CACHE_TOL: the owner wrote each
    new token and no other rank did."""
    ranks, ref = runs
    cfg = get_smoke_config(arch)
    want = port_cache(ref, f"{arch}{SEP}cache", cfg)
    cspecs = TM.cache_specs(cfg, rules_of(), False)
    for res in ranks:
        got = res["decode"][arch]["cache"]
        for path, whole in O.flatten(want):
            block = held(path, whole, cspecs, res["coords"])
            close(got[SEP.join(map(str, path))], block.numpy(), CACHE_TOL)


def test_seq_parallel_leaves_the_tp_decode_as_it_was(runs):
    """Under ``seq_parallel`` rules the decode is the plain rules' decode,
    bit for bit (the reference's decode never reads the field)."""
    ranks, _ = runs
    for res in ranks:
        for step in (0, 1):
            assert_bits(res["seq_parallel"]["logits"][step],
                        res["decode"]["tinyllama-1.1b"]["logits"][step])


@pytest.mark.parametrize("fault,arch", [(f, a) for f, archs in FAULTS.items() for a in archs])
def test_planted_fault_fails(runs, fault, arch):
    """A planted fault: the join without its rescale, or every rank writing
    the new token into its block, leaves MODEL_TOL of the reference's
    logits; the ``seq_parallel`` pair in the decode reaches the sequence
    pair (a tripwire on every rank: on one token a row the real pair fails
    on some ranks and leaves the first waiting)."""
    ranks, ref = runs
    got = [r["faults"][f"{fault}{SEP}{arch}"] for r in ranks]
    if fault == "seq_pair":
        assert all("seq_parallel pair" in g.get("error", "") for g in got), got
        return
    with pytest.raises(AssertionError):
        for step in (0, 1):
            close(np.concatenate([got[dc * MESH[1]]["logits"][step] for dc in range(MESH[0])]),
                  ref[f"{arch}{SEP}logits{SEP}{step}"], MODEL_TOL)


@pytest.mark.parametrize("case", list(JOIN_CASES))
def test_lse_combine_is_the_whole_softmax(runs, case):
    """On every rank the join of the ranks' partials is the softmax over all
    32 keys (float64, JOIN_TOL), also where a rank's block is all masked."""
    ranks, _ = runs
    for r in ranks:
        got, want = r["join"][case]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=JOIN_TOL)


class _Mesh:
    """A rank's view of a (1, 4) mesh with no process groups: the leaf
    checks run before any collective."""
    axis_names, shape, rank = AXES, (1, 4), 1
    sizes = {"data": 1, "model": 4}
    coords = {"data": 0, "model": 1}


LEAVES = [("tinyllama-1.1b", k) for k in ("wq", "wk", "wv", "wo")] + \
    [("deepseek-v3-671b", k) for k in ("wq_b", "wkv_b", "wo")]


@pytest.mark.parametrize("arch,leaf", LEAVES)
def test_a_whole_leaf_raises_in_the_decode(arch, leaf):
    """Under the tensor axis an attention leaf of its whole shape, where the
    rank's cut is due, raises ``ValueError`` naming it; nothing gathers or
    falls back."""
    cfg = get_smoke_config(arch)
    whole = TM.init_params(0, cfg, device="cpu")
    rules = SH.ShardRules(model_axis_size=4, data_axis_size=1)
    lp = TM.local_params(whole, cfg, rules, _Mesh.coords, _Mesh.sizes)
    tp = CL.TensorParallel(rules, _Mesh)
    layer = dict(lp["stack"][0]["mixer"], **{leaf: whole["stack"][0]["mixer"][leaf]})
    cache = TM.init_cache(cfg, 1, 8, torch.float32, device="cpu")["stack"][0]
    x = torch.zeros((1, 1, cfg.d_model))
    fn = A.mla_decode if cfg.attention == "mla" else A.gqa_decode
    with pytest.raises(ValueError, match=f"^{leaf} "):
        fn(layer, x, cache, cfg, 3, tp=tp)


def test_decode_cell_moves_no_cache_bytes():
    """TinyLlama smoke's decode cell on rank 0 of a fake (2, 4) world, 8 rows
    a rank: its collectives carry, by hand count, each layer's one
    all-gather of the new token's q, k and v columns, the max and the
    joined (o, l) of the split-KV attention, the attention's and the MLP's
    row sums, then the embedding's and the logits' all-gathers: the same
    bytes at a cache of 32 and of 1024 positions, none of them the cache's."""
    from repro_torch.launch import dryrun as D

    cfg = get_smoke_config("tinyllama-1.1b")
    rules = rules_of()
    Bl, H, Hkv, hd, d, V = 8, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model, cfg.vocab
    f32 = 4
    gather = cfg.n_layers * Bl * (H + 2 * Hkv) * hd * f32 + Bl * d * f32 + Bl * V * f32
    reduce = cfg.n_layers * (Bl * H + Bl * H * (hd + 1) + 2 * Bl * d) * f32
    want = {"all-gather": float(gather), "all-reduce": float(reduce),
            "_counts": {"all-gather": cfg.n_layers + 2, "all-reduce": 4 * cfg.n_layers}}
    for seq in (32, 1024):
        trace = D.trace_cell(cfg, ShapeConfig("smoke", seq, Bl * MESH[0], "decode"), rules, 1)
        got = D.run_trace(trace, rules, MESH, AXES, 0)
        assert got["collectives"] == want, (seq, got["collectives"], want)
