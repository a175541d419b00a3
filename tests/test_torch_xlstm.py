"""The port's mLSTM and sLSTM mixers and xLSTM smoke against the JAX package,
on the CPU.

Parameters come from the JAX package's inits and are carried across as
numpy arrays (``models.convert.params_from_jax`` for whole models); inputs
are made by numpy from a seed. Everything runs in float32: the layers'
train and decode forms, with their states, within rtol = atol = 1e-5
(``LAYER_TOL``), whole forwards, losses and decode logits and states
within 1e-4 (``MODEL_TOL``). The port's three mLSTM forms agree with each
other within the JAX package's own bounds (``tests/test_xlstm_forms.py``:
chunked against parallel 2e-4, train against decode 3e-3). Engines are
compared token for token against the JAX engine on fresh slots, as in
``tests/test_torch_mamba.py``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as j_smoke
from repro.models import model as JM
from repro.models import xlstm as JXL
from repro.serve.engine import Engine as JEngine, Request as JRequest

from repro_torch.configs import get_smoke_config
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as XL
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.engine import Engine as TEngine, Request as TRequest

LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
ARCH = "xlstm-1.3b"


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach().double()), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def to_torch(tree):
    if isinstance(tree, dict):
        return {key: to_torch(val) for key, val in tree.items()}
    return torch.from_numpy(np.array(tree))


def layer(init, seed=0):
    jp = init(jax.random.key(seed), j_smoke(ARCH), jnp.float32)
    return get_smoke_config(ARCH), jp, to_torch(jp)


def normals(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def inner_inputs(B=2, S=48, H=4, dh=16, seed=0):
    """q, k, v, i_pre, f_pre as ``tests/test_xlstm_forms.py`` makes them."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, H, dh)), rng.standard_normal((B, S, H, dh)) / np.sqrt(dh),
            rng.standard_normal((B, S, H, dh)), rng.standard_normal((B, S, H)),
            rng.standard_normal((B, S, H)) + 2.0]
    arrs = [a.astype(np.float32) for a in arrs]
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


# ------------------------------------------------------------------- mLSTM
def test_mlstm_parallel_inner_matches():
    j, t = inner_inputs()
    close(XL.mlstm_parallel_inner(*t), JXL.mlstm_parallel_inner(*j), LAYER_TOL)


@pytest.mark.parametrize("chunk", [8, 16, 48])
def test_mlstm_chunked_inner_matches(chunk):
    j, t = inner_inputs(seed=1)
    close(XL.mlstm_chunked_inner(*t, chunk), JXL.mlstm_chunked_inner(*j, chunk), LAYER_TOL)


@pytest.mark.parametrize("S,chunk", [(12, 16), (48, 16)], ids=["parallel", "chunked"])
def test_mlstm_train_matches(S, chunk):
    cfg, jp, tp = layer(JXL.mlstm_init)
    x = normals((2, S, cfg.d_model), 2)
    close(XL.mlstm_train(tp, torch.from_numpy(x), cfg, chunk=chunk),
          JXL.mlstm_train(jp, jnp.asarray(x), j_smoke(ARCH), chunk=chunk), LAYER_TOL)


def test_mlstm_decode_matches_with_its_state():
    cfg, jp, tp = layer(JXL.mlstm_init, 3)
    B = 3
    js = JXL.mlstm_state_init(j_smoke(ARCH), B, jnp.float32)
    ts = XL.mlstm_state_init(cfg, B, torch.float32, "cpu")
    for step in range(5):
        x = normals((B, 1, cfg.d_model), 10 + step)
        jy, js = JXL.mlstm_decode(jp, jnp.asarray(x), js, j_smoke(ARCH))
        ty, ts = XL.mlstm_decode(tp, torch.from_numpy(x), ts, cfg)
        close(ty, jy, LAYER_TOL)
        assert set(ts) == set(js) == {"C", "n", "m"} and ts["m"].dtype == torch.float32
        for key in ts:
            close(ts[key], js[key], LAYER_TOL)


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_chunked_and_parallel_forms_are_one_function_in_float64(chunk):
    """In float64 the two inner forms agree to 1e-12: their float32
    distance is rounding (at long sequences mostly the parallel form's,
    whose weights span the whole past)."""
    _, t = inner_inputs(S=64, seed=4)
    t = [a.double() for a in t]
    close(XL.mlstm_chunked_inner(*t, chunk), XL.mlstm_parallel_inner(*t), 1e-12)
    assert XL.mlstm_parallel_inner(*t).dtype == torch.float64


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_the_three_mlstm_forms_agree(chunk):
    """Chunked against parallel (2e-4), and the train form against the
    decode recurrence stepped token by token (3e-3), the JAX package's
    bounds for its own forms."""
    _, t = inner_inputs(S=64, seed=4)
    close(XL.mlstm_chunked_inner(*t, chunk), XL.mlstm_parallel_inner(*t), 2e-4)
    cfg, _, tp = layer(JXL.mlstm_init, 5)
    x = torch.from_numpy(normals((2, 32, cfg.d_model), 6))
    state = XL.mlstm_state_init(cfg, 2, torch.float32, "cpu")
    outs = []
    for i in range(x.shape[1]):
        y, state = XL.mlstm_decode(tp, x[:, i:i + 1], state, cfg)
        outs.append(y[:, 0])
    close(torch.stack(outs, 1), XL.mlstm_train(tp, x, cfg, chunk=chunk), 3e-3)


# ------------------------------------------------------------------- sLSTM
def test_slstm_train_matches():
    cfg, jp, tp = layer(JXL.slstm_init, 7)
    x = normals((2, 21, cfg.d_model), 8)
    close(XL.slstm_train(tp, torch.from_numpy(x), cfg),
          JXL.slstm_train(jp, jnp.asarray(x), j_smoke(ARCH)), LAYER_TOL)


def test_slstm_decode_matches_with_its_state():
    cfg, jp, tp = layer(JXL.slstm_init, 9)
    B = 3
    js = JXL.slstm_state_init(j_smoke(ARCH), B, jnp.float32)
    ts = XL.slstm_state_init(cfg, B, torch.float32, "cpu")
    for step in range(5):
        x = normals((B, 1, cfg.d_model), 20 + step)
        jy, js = JXL.slstm_decode(jp, jnp.asarray(x), js, j_smoke(ARCH))
        ty, ts = XL.slstm_decode(tp, torch.from_numpy(x), ts, cfg)
        close(ty, jy, LAYER_TOL)
        assert set(ts) == set(js) == {"c", "n", "h", "m"}
        for key in ts:
            assert ts[key].dtype == torch.float32
            close(ts[key], js[key], LAYER_TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_init_follows_the_jax_package(kind):
    """The same tree, shapes and dtypes; the fixed tensors equal; the random
    ones at the JAX package's scales."""
    cfg = get_smoke_config(ARCH)
    ours = getattr(XL, f"{kind}_init")(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    theirs = getattr(JXL, f"{kind}_init")(jax.random.key(0), j_smoke(ARCH), jnp.float32)
    flat = lambda tree: {key: val for key, val in tree.items() if key != "ogate_norm"}
    if kind == "mlstm":
        close(ours["ogate_norm"]["scale"], theirs["ogate_norm"]["scale"], 0)
    assert set(ours) == set(theirs)
    for key, val in flat(ours).items():
        want = np.asarray(theirs[key])
        assert tuple(val.shape) == want.shape and val.dtype == torch.float32
        if key.startswith("b_"):
            close(val, want, 0)
        else:
            assert abs(float(val.std()) / float(want.std()) - 1) < 0.15, key
            assert float(val.abs().max()) <= 2 * float(np.abs(want).max()), key


# ------------------------------------------------------------ xLSTM smoke, whole
@pytest.fixture(scope="module")
def xlstm():
    jp = JM.init_params(jax.random.key(0), j_smoke(ARCH))
    cfg = get_smoke_config(ARCH)
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(1, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("S", [16, 512], ids=["parallel", "chunked"])
def test_forward_and_loss_match(xlstm, S):
    """7 mLSTM blocks and 1 sLSTM block, no FFN; at 512 positions the
    mLSTM takes its chunkwise form (chunks of 256)."""
    cfg, jp, tp = xlstm
    tok = tokens(cfg, 2, S, 4)
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(tok)}
    tb = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(tok)}
    jl, _, jh = JM.forward_train(jp, jb, j_smoke(ARCH))
    tl, taux, th = TM.forward_train(tp, tb, cfg)
    close(tl, jl, MODEL_TOL)
    close(th, jh, MODEL_TOL)
    assert float(taux) == 0.0
    jloss, _ = JM.loss_fn(jp, jb, j_smoke(ARCH))
    tloss, metrics = TM.loss_fn(tp, tb, cfg)
    close(tloss, jloss, MODEL_TOL)
    assert set(metrics) == {"ce", "loss"}


def test_decode_steps_match_with_every_state(xlstm):
    """4 decode steps at per-slot positions: logits and every layer's state."""
    cfg, jp, tp = xlstm
    B = 3
    jc = JM.init_cache(j_smoke(ARCH), B, 16, dtype=jnp.float32)
    tc = TM.init_cache(cfg, B, 16, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(6)
    pos = np.array([0, 3, 7], np.int32)
    for _ in range(4):
        tok = rng.integers(1, cfg.vocab, B).astype(np.int32)
        jlog, jc = JM.decode_step(jp, jc, {"token": jnp.asarray(tok)}, jnp.asarray(pos),
                                  j_smoke(ARCH))
        tlog, tc = TM.decode_step(tp, tc, {"token": torch.from_numpy(tok)},
                                  torch.from_numpy(pos.copy()), cfg)
        close(tlog, jlog, MODEL_TOL)
        pos = pos + 1
    kinds = [mixer for mixer, _ in TT.layer_kinds(cfg)]
    assert kinds == ["mlstm"] * 7 + ["slstm"]
    for layer_, (tcache, mixer) in enumerate(zip(tc["stack"], kinds)):
        jcache = jc["stack"][layer_]  # one group: layer l is member l
        assert set(tcache) == set(jcache) == ({"C", "n", "m"} if mixer == "mlstm"
                                              else {"c", "n", "h", "m"})
        for key in tcache:
            close(tcache[key], jcache[key][0], MODEL_TOL)


def test_decode_matches_the_forward_at_the_last_prompt_token(xlstm):
    cfg, _, tp = xlstm
    prompt = tokens(cfg, 1, 11, 7)[0]
    cache = TM.init_cache(cfg, 1, 16, dtype=torch.float32, device="cpu")
    for i, tok in enumerate(prompt):
        logits, cache = TM.decode_step(tp, cache, {"token": torch.tensor([tok])}, i, cfg)
    full = TM.forward_train(tp, {"tokens": torch.from_numpy(prompt)[None]}, cfg)[0]
    close(logits[0], full[0, -1], MODEL_TOL)


# --------------------------------------------------------------------- engine
def prompts(seed, n, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=rng.integers(3, 9)).astype(np.int32) for _ in range(n)]


def serve_loop(eng, Request, prompt_list, max_new):
    """The launcher's loop; returns each request's tokens in request order."""
    reqs = [Request(rid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompt_list)]
    pending = list(reqs)
    while pending or eng.slot_req:
        while pending and eng.free_slots:
            eng.admit(pending.pop(0))
        eng.step()
    return [r.out for r in reqs]


def jax_fresh_tokens(jp, prompt_list, slots, max_seq, max_new):
    """Each request alone in a new JAX engine (one compiled step shared)."""
    outs, step = [], None
    for p in prompt_list:
        eng = JEngine(j_smoke(ARCH), jp, batch_slots=slots, max_seq=max_seq)
        eng._step = step or eng._step
        step = eng._step
        outs.extend(serve_loop(eng, JRequest, [p], max_new))
    return outs


def test_engine_matches_the_jax_engine_on_fresh_slots(xlstm):
    """As for Jamba (``tests/test_torch_mamba.py``)."""
    cfg, jp, tp = xlstm
    ps = prompts(3, 4)
    teng = TEngine(cfg, tp, batch_slots=4, max_seq=64, device="cpu")
    jeng = JEngine(j_smoke(ARCH), jp, batch_slots=4, max_seq=64)
    got = serve_loop(teng, TRequest, ps, 6)
    leaked = serve_loop(jeng, JRequest, ps, 6)
    assert got == jax_fresh_tokens(jp, ps, 4, 64, 6)
    # the JAX engine's slots 1-3 took request 0's prefill steps while free
    assert leaked[0] == got[0] and leaked != got
    assert (teng.steps_run, teng.tokens_out) == (jeng.steps_run, jeng.tokens_out)
    np.testing.assert_array_equal(teng.positions, jeng.positions)


def test_a_reused_slot_gives_a_fresh_engines_tokens(xlstm):
    """One slot serves three requests in turn: the port gives each a fresh
    engine's tokens; the JAX engine's later two carry the earlier state."""
    cfg, jp, tp = xlstm
    ps = prompts(5, 3)
    fresh = jax_fresh_tokens(jp, ps, 1, 64, 6)
    assert serve_loop(TEngine(cfg, tp, batch_slots=1, max_seq=64, device="cpu"), TRequest, ps,
                      6) == fresh
    leaked = serve_loop(JEngine(j_smoke(ARCH), jp, batch_slots=1, max_seq=64), JRequest, ps, 6)
    assert leaked[0] == fresh[0] and leaked[1:] != fresh[1:]

