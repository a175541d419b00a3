"""The port's training substrate against the JAX package, on the CPU: the
optimizer, the learning-rate schedule, gradient compression, the data
pipeline, checkpoints and the Mamba scan's training form.

Trees are made in the JAX package's layout (each member of ``stack``
stacked over its layer groups, the dense ``prefix`` over its layers) and
carried across by ``models.convert.params_from_jax`` and
``opt_state_from_jax``; the comparisons run on the port's per-layer
layout. The optimizer agrees within rtol = atol = 1e-6 (float32, the same
formulas; reductions sum in another order), compression codes exactly
and scales within 1e-7, the data pipeline byte for byte. The scan's
training form is held to the step-by-step recurrence under autograd
within 1e-5.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as j_smoke
from repro.models import model as JM
from repro.train import checkpoint as jckpt
from repro.train import compression as JC
from repro.train import optimizer as JO
from repro.train.data import DataState as JDataState, SyntheticLM as JSyntheticLM

from repro_torch.configs import get_smoke_config
from repro_torch.models import mamba as MB
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression as C
from repro_torch.train import optimizer as O
from repro_torch.train.data import DataState, SyntheticLM

OPT_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for torch while a module runs: smoke shapes gain
    nothing from more, and under pytest-xdist each worker's full pool
    contends with the other workers'. The training test files import it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def configs(arch, wide=False):
    """(JAX config, port config); ``wide`` widens the smoke config so its
    matrices reach ``_factorable``'s 128 x 128."""
    jc, tc = j_smoke(arch), get_smoke_config(arch)
    if wide:
        jc = dataclasses.replace(jc, d_model=128, d_ff=256,
                                 moe=dataclasses.replace(jc.moe, d_ff_expert=128))
        tc = dataclasses.replace(tc, d_model=128, d_ff=256,
                                 moe=dataclasses.replace(tc.moe, d_ff_expert=128))
    return jc, tc


def like(tree, rng, fn=lambda a: a):
    """A tree shaped as ``tree`` of float32 normals from ``rng``."""
    return jax.tree.map(lambda a: fn(rng.standard_normal(a.shape).astype(np.float32)), tree)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def close_trees(got, want, tol):
    flat_got, flat_want = dict(O.flatten(got)), dict(O.flatten(want))
    assert flat_got.keys() == flat_want.keys()
    for path, a in flat_got.items():
        b = flat_want[path]
        assert a.shape == b.shape and a.dtype == b.dtype, path
        close(a, b.numpy(), tol)


# ----------------------------------------------------------------- optimizer
CASES = [("tinyllama-1.1b", False, False), ("jamba-1.5-large-398b", False, False),
         ("deepseek-v3-671b", False, False), ("mixtral-8x7b", True, False),
         ("mixtral-8x7b", True, True)]


@pytest.mark.parametrize("step", [1, 2, 50])
@pytest.mark.parametrize("clip", [True, False], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("arch,wide,factored", CASES,
                         ids=["tinyllama", "jamba", "deepseek", "mixtral-wide",
                              "mixtral-wide-factored"])
def test_apply_updates_matches(arch, wide, factored, clip, step):
    """One update from a random state at ``step`` - 1 (moments from the
    seed, second moments positive), gradients large enough to clip or
    scaled under the clip: parameters, moments, grad_norm and lr."""
    jc, tc = configs(arch, wide)
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=80, factored=factored)
    jcfg, tcfg = JO.OptConfig(**cfg), O.OptConfig(**cfg)
    rng = np.random.default_rng(step)
    params = JM.init_params(jax.random.key(0), jc)
    state = JO.init_state(params, jcfg)
    if factored:
        assert any("vr" in leaf for leaf in jax.tree.leaves(
            state["mu"], is_leaf=lambda x: isinstance(x, dict) and "m" in x))
    state = {"mu": jax.tree.map(
        lambda a: jnp.asarray(np.abs(rng.standard_normal(a.shape)).astype(np.float32) * 1e-3),
        state["mu"]), "step": jnp.asarray(step - 1, jnp.int32)}
    grads = like(params, rng, lambda a: a * (1.0 if clip else 1e-4))
    np_state = jax.tree.map(np.asarray, state)
    tp = params_from_jax(jax.tree.map(np.asarray, params), tc, device="cpu")
    tg = params_from_jax(grads, tc, device="cpu")
    ts = opt_state_from_jax(np_state, tc, device="cpu")
    assert O.flatten(O.init_state(tp, tcfg)["mu"])[0][0] == O.flatten(ts["mu"])[0][0]

    jp2, js2, jm = jax.jit(JO.apply_updates, static_argnums=3)(
        params, jax.tree.map(jnp.asarray, grads), state, jcfg)
    tp2, ts2, tm = O.apply_updates(tp, tg, ts, tcfg)
    assert (float(jm["grad_norm"]) > 1.0) == clip
    close(tm["grad_norm"], jm["grad_norm"], OPT_TOL)
    close(tm["lr"], jm["lr"], OPT_TOL)
    assert int(ts2["step"]) == int(js2["step"]) == step
    close_trees(tp2, params_from_jax(jax.tree.map(np.asarray, jp2), tc, device="cpu"), OPT_TOL)
    close_trees(ts2["mu"], opt_state_from_jax(jax.tree.map(np.asarray, js2), tc,
                                              device="cpu")["mu"], OPT_TOL)


def test_init_state_matches_the_jax_layout():
    """Factored leaves are the reference's: the same moments, unstacked."""
    jc, tc = configs("mixtral-8x7b", wide=True)
    cfg = dict(factored=True)
    params = JM.init_params(jax.random.key(0), jc)
    want = opt_state_from_jax(jax.tree.map(np.asarray, JO.init_state(params, JO.OptConfig(**cfg))),
                              tc, device="cpu")
    got = O.init_state(params_from_jax(jax.tree.map(np.asarray, params), tc, device="cpu"),
                       O.OptConfig(**cfg))
    close_trees(got["mu"], want["mu"], 0.0)
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 0


def test_decay_follows_the_stacked_shape():
    """A stacked leaf decays whatever its per-layer rank (TinyLlama smoke's
    norm1 scale is (2, 64) in the JAX package); final_norm (64,) does
    not: with a zero gradient only the decay moves a parameter."""
    jc, tc = configs("tinyllama-1.1b")
    cfg = O.OptConfig(lr=0.1, warmup_steps=0, weight_decay=0.5)
    tp = params_from_jax(jax.tree.map(np.asarray, JM.init_params(jax.random.key(0), jc)), tc,
                         device="cpu")
    zeros = O.unflatten(tp, [torch.zeros_like(p) for _, p in O.flatten(tp)])
    new, _, _ = O.apply_updates(tp, zeros, O.init_state(tp, cfg), cfg)
    assert not torch.equal(new["stack"][0]["norm1"]["scale"], tp["stack"][0]["norm1"]["scale"])
    assert torch.equal(new["final_norm"]["scale"], tp["final_norm"]["scale"])
    assert O.reference_ndim(("stack", 0, "norm1", "scale"), (64,)) == 2
    assert O.reference_ndim(("mtp", "norm", "scale"), (64,)) == 1


def test_a_missing_gradient_counts_as_zero():
    """``None`` (a leaf the loss does not reach) updates as a zero
    gradient does: moments and decay, as under ``jax.value_and_grad``."""
    jc, tc = configs("musicgen-large")
    cfg = O.OptConfig(lr=1e-2, warmup_steps=0)
    params = JM.init_params(jax.random.key(0), jc)
    grads = like(params, np.random.default_rng(0))
    grads["embed"]["table"] = np.zeros_like(grads["embed"]["table"])
    tp = params_from_jax(jax.tree.map(np.asarray, params), tc, device="cpu")
    tg = params_from_jax(grads, tc, device="cpu")
    want = O.apply_updates(tp, tg, O.init_state(tp, cfg), cfg)
    tg["embed"]["table"] = None
    got = O.apply_updates(tp, tg, O.init_state(tp, cfg), cfg)
    close_trees(got[0], want[0], 0.0)
    close_trees(got[1]["mu"], want[1]["mu"], 0.0)
    assert float(got[2]["grad_norm"]) == float(want[2]["grad_norm"])


def test_lr_schedule_matches():
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=100)
    for step in list(range(0, 120, 3)) + [10, 100]:
        close(O.lr_at(O.OptConfig(**cfg), step), JO.lr_at(JO.OptConfig(**cfg), step), OPT_TOL)
    assert O.lr_at(O.OptConfig(**cfg), torch.tensor(5, dtype=torch.int32)).dtype == torch.float32


# --------------------------------------------------------------- compression
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "jamba-1.5-large-398b",
                                  "deepseek-v3-671b"])
def test_compress_tree_matches_on_the_stacked_layout(arch):
    """Blocks of 256 over each stacked JAX leaf (a smoke (2, 64) norm is
    one block across both layers): codes exact, scales within 1e-7, the
    new error and the dequantized gradients within 1e-6, per layer."""
    jc, tc = configs(arch)
    period = len(tc.layer_kinds())
    rng = np.random.default_rng(1)
    params = JM.init_params(jax.random.key(0), jc)
    grads = like(params, rng)
    err = like(params, rng, lambda a: a * 1e-3)
    jcodes, jerr = JC.compress_tree(jax.tree.map(jnp.asarray, grads),
                                    jax.tree.map(jnp.asarray, err))
    tg = params_from_jax(grads, tc, device="cpu")
    codes, terr = C.compress_tree(tg, params_from_jax(err, tc, device="cpu"), period)
    jflat = jax.tree_util.tree_flatten_with_path(
        jcodes, is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
        and not isinstance(x[0], dict))[0]
    want = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): code
            for path, code in jflat}
    assert set(codes) == set(want)
    for path, (q, s) in codes.items():
        np.testing.assert_array_equal(q.numpy(), np.asarray(want[path][0]))
        close(s, want[path][1], 1e-7)
    close_trees(terr, params_from_jax(jax.tree.map(np.asarray, jerr), tc, device="cpu"), 1e-6)
    close_trees(C.decompress_tree(codes, tg, period),
                params_from_jax(jax_decompress(jcodes, grads), tc, device="cpu"), 1e-6)


def jax_decompress(jcodes, like):
    """The reference's ``decompress_tree``, each leaf's ``dequantize``,
    walked by path: its own first line (``flat_codes``) raises on any
    tree that holds a tuple, as a model's ``stack`` does."""
    codes = dict(jax.tree_util.tree_flatten_with_path(
        jcodes, is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
        and not isinstance(x[0], dict))[0])
    return jax.tree_util.tree_map_with_path(
        lambda path, g: np.asarray(JC.dequantize(*codes[path], g.shape, g.size)), like)


@pytest.mark.parametrize("shape", [(7,), (256,), (3, 300), (2, 64)])
def test_quantize_matches(shape):
    g = np.random.default_rng(2).standard_normal(shape).astype(np.float32) * 3
    g.reshape(-1)[:min(g.size, 256)] = 0.0  # an all-zero block takes scale 1
    q, s = C.quantize(torch.from_numpy(g))
    jq, js = JC.quantize(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    close(s, js, 1e-7)
    close(C.dequantize(q, s, shape, g.size), JC.dequantize(jq, js, shape, g.size), 0.0)


def test_error_feedback_converges():
    """Accumulated dequantized gradients plus the final error equal the
    accumulated true gradients (the reference's own check)."""
    g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal((64, 64))
                               .astype(np.float32))}
    err = C.init_error(g)
    total = torch.zeros(64, 64)
    for _ in range(10):
        codes, err = C.compress_tree(g, err, 1)
        total += C.decompress_tree(codes, g, 1)["w"]
    close(total + err["w"], 10 * g["w"].numpy(), 1e-4)


# ---------------------------------------------------------------------- data
@pytest.mark.parametrize("seed,shard,num_shards", [(0, 0, 1), (7, 1, 2), (123, 3, 4)])
def test_synthetic_batches_are_the_references(seed, shard, num_shards):
    kw = dict(seed=seed, batch=3, seq=17, vocab=101, shard=shard, num_shards=num_shards)
    ours, theirs = SyntheticLM(DataState(**kw)), JSyntheticLM(JDataState(**kw))
    for _ in range(3):
        a, b = ours.next_batch(), theirs.next_batch()
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes()
        a, b = ours.next_embeds_batch(24), theirs.next_embeds_batch(24)
        assert a.keys() == b.keys() == {"labels", "embeds"}
        for key in a:
            assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes()
    assert ours.state.to_dict() == theirs.state.to_dict()


# --------------------------------------------------------------- checkpoints
def test_checkpoint_roundtrip_keeps_bf16_bits(tmp_path):
    bits = np.random.default_rng(0).integers(0, 1 << 16, (5, 7), dtype=np.uint16)
    bf16 = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)  # NaN payloads too
    tree = {
        "params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3), "b": bf16},
        "opt": ({"m": np.ones(3)},),
        "stack": [{"x": torch.tensor([1, 2], dtype=torch.int32)}],
        "data": {"seed": 1, "step": 7},
    }
    ckpt.save(tmp_path, 5, tree)
    step, back = ckpt.restore(tmp_path)
    assert step == 5
    np.testing.assert_array_equal(back["params"]["w"], tree["params"]["w"].numpy())
    assert back["params"]["b"].dtype == torch.bfloat16
    assert torch.equal(back["params"]["b"].view(torch.int16), bf16.view(torch.int16))
    np.testing.assert_array_equal(back["opt"][0]["m"], np.ones(3))
    np.testing.assert_array_equal(back["stack"][0]["x"], [1, 2])
    assert int(back["data"]["step"]) == 7
    manifest = json.loads((tmp_path / "step_00000005" / "manifest.json").read_text())
    assert manifest["bfloat16"] == ["params/b"] and manifest["num_arrays"] == 6


def test_checkpoints_are_the_references_format(tmp_path):
    """Each package restores the other's checkpoint of the same numpy tree,
    with the same npz keys and manifest fields."""
    tree = {"a": {"w": np.arange(12, dtype=np.float32).reshape(3, 4)},
            "s": ({"m": np.ones(3, np.int32)}, {"m": np.zeros(2)}), "data": {"step": 3}}
    ckpt.save(tmp_path / "port", 2, tree)
    jckpt.save(tmp_path / "jax", 2, tree)
    for saved, reader in (("port", jckpt), ("jax", ckpt)):
        step, back = reader.restore(tmp_path / saved)
        assert step == 2
        np.testing.assert_array_equal(back["a"]["w"], tree["a"]["w"])
        np.testing.assert_array_equal(back["s"][1]["m"], tree["s"][1]["m"])
    files = [np.load(tmp_path / d / "step_00000002" / "arrays.npz").files for d in ("port", "jax")]
    assert files[0] == files[1]
    manifests = [json.loads((tmp_path / d / "step_00000002" / "manifest.json").read_text())
                 for d in ("port", "jax")]
    assert manifests[0].keys() == manifests[1].keys()


def test_checkpoint_retention_and_latest(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ckpt.save(tmp_path, s, {"x": torch.zeros(1)}, keep=3)
    assert ckpt.latest_step(tmp_path) == 5
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000003", "step_00000004", "step_00000005"]


def test_checkpoint_corruption_detected(tmp_path):
    ckpt.save(tmp_path, 1, {"x": torch.arange(10.0)})
    f = next(pathlib.Path(tmp_path).glob("step_*/arrays.npz"))
    data = bytearray(f.read_bytes())
    data[len(data) // 2] ^= 0xFF
    f.write_bytes(bytes(data))
    with pytest.raises(IOError, match="digest mismatch"):
        ckpt.restore(tmp_path)


def test_restore_verify_raises_on_truncated_npz(tmp_path):
    ckpt.save(tmp_path, 2, {"w": torch.arange(64, dtype=torch.float32)})
    arrays = tmp_path / "step_00000002" / "arrays.npz"
    blob = arrays.read_bytes()
    arrays.write_bytes(blob[: len(blob) // 2])
    with pytest.raises(IOError, match="digest mismatch"):
        ckpt.restore(tmp_path, verify=True)


def test_latest_step_ignores_stray_files(tmp_path):
    ckpt.save(tmp_path, 3, {"x": np.zeros(1)})
    ckpt.save(tmp_path, 7, {"x": np.ones(1)})
    (tmp_path / "step_tmp").write_text("leftover")          # stray file
    (tmp_path / "step_00000099").write_text("not a dir")    # file, big step
    (tmp_path / "step_bogus").mkdir()                        # unparseable dir
    assert ckpt.latest_step(tmp_path) == 7
    step, tree = ckpt.restore(tmp_path)
    assert step == 7 and float(tree["x"][0]) == 1.0


def test_data_state_restore_roundtrip(tmp_path):
    data = SyntheticLM(DataState(seed=5, batch=2, seq=8, vocab=32))
    for _ in range(3):
        data.next_batch()
    ckpt.save(tmp_path, 3, {"data": data.state.to_dict()})
    expected = data.next_batch()
    _, tree = ckpt.restore(tmp_path)
    state = DataState.from_dict(tree["data"])
    for f, v in state.__dict__.items():
        assert type(v) is int, (f, type(v))
    np.testing.assert_array_equal(SyntheticLM(state).next_batch()["tokens"], expected["tokens"])


# ------------------------------------------------ the Mamba scan's training form
@pytest.mark.parametrize("S,chunk,block_tokens", [(12, 32, 512), (48, 16, 64), (45, 16, 64),
                                                  (37, 5, 40), (64, 4, 512)],
                         ids=["one-chunk", "blocks", "ragged", "short-chunks", "many-chunks"])
def test_scan_training_form_matches_the_step_by_step_gradients(monkeypatch, S, chunk,
                                                                block_tokens):
    """y and the gradients of dt, x, B, C and A through the training form
    (``_SelectiveScan``: blocks recomputed from their saved entering
    states, the adjoint scanned back) against autograd through the
    step-by-step recurrence, across chunks and blocks."""
    monkeypatch.setattr(MB, "CHUNK", chunk)
    monkeypatch.setattr(MB, "TRAIN_BLOCK_TOKENS", block_tokens)
    rng = np.random.default_rng(S)
    Bsz, di, N = 2, 12, 4

    def leaf(*shape, scale=1.0, shift=0.0):
        x = rng.standard_normal(shape).astype(np.float32) * scale + shift
        return torch.from_numpy(x).requires_grad_(True)

    dt = torch.nn.functional.softplus(leaf(Bsz, S, di)).detach().requires_grad_(True)
    ins = (dt, leaf(Bsz, S, di), leaf(Bsz, S, N), leaf(Bsz, S, N), -leaf(di, N, scale=0.3,
                                                                        shift=1.0).abs())
    ins = ins[:4] + (ins[4].detach().requires_grad_(True),)
    gy = torch.from_numpy(rng.standard_normal((Bsz, S, di)).astype(np.float32))
    outs = []
    for fn in (MB.selective_scan, MB.selective_scan_plain):
        y = fn(*ins)
        outs.append((y.detach(), torch.autograd.grad(y, ins, gy)))
    (y, grads), (y_ref, grads_ref) = outs
    close(y, y_ref.numpy(), 1e-5)
    for g, g_ref in zip(grads, grads_ref):
        scale = float(g_ref.abs().max())
        close(g / scale, (g_ref / scale).numpy(), 1e-5)


def test_scan_serving_form_runs_without_autograd(monkeypatch):
    """With no input needing a gradient the serving form runs, and at the
    same block size it gives the training form's bits."""
    monkeypatch.setattr(MB, "TRAIN_BLOCK_TOKENS", MB.BLOCK_TOKENS)
    rng = np.random.default_rng(0)
    ins = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           for s in ((1, 40, 6), (1, 40, 6), (1, 40, 3), (1, 40, 3))]
    ins[0] = torch.nn.functional.softplus(ins[0])
    A = -torch.ones(6, 3)
    y0 = MB.selective_scan(*ins, A)
    y1 = MB.selective_scan(*ins, A.clone().requires_grad_(True))
    assert y0.grad_fn is None and y1.grad_fn is not None
    assert torch.equal(y0, y1.detach())
