"""The port's Mamba mixer and Jamba smoke against the JAX package, on the CPU.

Parameters come from the JAX package's inits and are carried across as
numpy arrays (``models.convert.params_from_jax`` for whole models); inputs
are made by numpy from a seed. Everything runs in float32: the layer's
train and decode forms within rtol = atol = 1e-5 (``LAYER_TOL``), whole
forwards, losses and decode logits and states within 1e-4 (``MODEL_TOL``).
The port's chunked scan sums in another order than the reference's
``associative_scan``, so it is held to those tolerances, not to the bit.
Engines are compared token for token: the port's against the JAX engine
on fresh slots (a JAX engine that took no step before the request came),
since the JAX engine carries a slot's recurrent state into the next
request that slot seats and the port resets it.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as j_smoke
from repro.models import mamba as JMB
from repro.models import model as JM
from repro.serve.engine import Engine as JEngine, Request as JRequest

from repro_torch.configs import get_smoke_config
from repro_torch.models import mamba as MB
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.engine import Engine as TEngine, Request as TRequest

LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
ARCH = "jamba-1.5-large-398b"


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def layer(seed=0):
    cfg = get_smoke_config(ARCH)
    jp = JMB.mamba_init(jax.random.key(seed), j_smoke(ARCH), jnp.float32)
    return cfg, jp, {key: torch.from_numpy(np.array(val)) for key, val in jp.items()}


def normals(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------------- the layer
@pytest.mark.parametrize("S,chunk", [(12, 32), (48, 16), (45, 16), (9, 4)],
                         ids=["S<=chunk", "S=3chunks", "ragged", "S=2chunks+1"])
@pytest.mark.parametrize("block_tokens", [512, 64], ids=["one-block", "blocks"])
def test_mamba_train_matches(monkeypatch, S, chunk, block_tokens):
    """At S within a chunk, a whole number of chunks and a ragged S, in one
    block of side-by-side chunks and across blocks (64 tokens at batch 2
    are blocks of 32 positions, the state carried between them)."""
    monkeypatch.setattr(MB, "CHUNK", chunk)
    monkeypatch.setattr(MB, "BLOCK_TOKENS", block_tokens)
    cfg, jp, tp = layer()
    x = normals((2, S, cfg.d_model), 1)
    close(MB.mamba_train(tp, torch.from_numpy(x), cfg),
          JMB.mamba_train(jp, jnp.asarray(x), j_smoke(ARCH)), LAYER_TOL)


@pytest.mark.parametrize("chunk", [1, 5, 16, 64])
def test_chunked_scan_matches_the_step_by_step_scan(monkeypatch, chunk):
    monkeypatch.setattr(MB, "CHUNK", chunk)
    monkeypatch.setattr(MB, "BLOCK_TOKENS", 40)
    cfg, _, tp = layer(2)
    ins = MB.scan_inputs(tp, torch.from_numpy(normals((2, 37, cfg.d_model), 3)), cfg)
    xc, _, dt, Bm, Cm, A = ins
    close(MB.selective_scan(dt, xc, Bm, Cm, A), MB.selective_scan_plain(dt, xc, Bm, Cm, A),
          LAYER_TOL)


def test_mamba_decode_matches_with_its_state():
    """Several decode steps, the state carried on both sides and compared."""
    cfg, jp, tp = layer(3)
    B = 3
    js = JMB.mamba_state_init(j_smoke(ARCH), B, jnp.float32)
    ts = MB.mamba_state_init(cfg, B, torch.float32, "cpu")
    for step in range(5):
        x = normals((B, 1, cfg.d_model), 10 + step)
        jy, js = JMB.mamba_decode(jp, jnp.asarray(x), js, j_smoke(ARCH))
        ty, ts = MB.mamba_decode(tp, torch.from_numpy(x), ts, cfg)
        close(ty, jy, LAYER_TOL)
        assert set(ts) == set(js) == {"conv", "ssm"}
        for key in ts:
            close(ts[key], js[key], LAYER_TOL)


def test_decode_token_by_token_is_the_train_forms_last_row(monkeypatch):
    monkeypatch.setattr(MB, "CHUNK", 8)
    cfg, _, tp = layer(4)
    x = torch.from_numpy(normals((2, 19, cfg.d_model), 5))
    state = MB.mamba_state_init(cfg, 2, torch.float32, "cpu")
    for t in range(x.shape[1]):
        y, state = MB.mamba_decode(tp, x[:, t:t + 1], state, cfg)
    close(y[:, 0], MB.mamba_train(tp, x, cfg)[:, -1], LAYER_TOL)


def test_init_follows_the_jax_package():
    """The same tree, shapes and dtypes; the fixed tensors equal; the random
    ones at the JAX package's scales."""
    cfg = get_smoke_config(ARCH)
    ours = MB.mamba_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    theirs = JMB.mamba_init(jax.random.key(0), j_smoke(ARCH), jnp.float32)
    assert set(ours) == set(theirs)
    for key, val in ours.items():
        want = np.asarray(theirs[key])
        assert tuple(val.shape) == want.shape and val.dtype == torch.float32
        if key in ("conv_b", "A_log", "D"):  # log(1..N) within float32 rounding
            close(val, want, 1e-6)
        elif key == "dt_bias":  # softplus(dt_bias) is U(log 1e-3, log 0.1) exponentiated
            dt = torch.nn.functional.softplus(val)
            assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 0.1 * (1 + 1e-5)
        else:
            assert abs(float(val.std()) / float(want.std()) - 1) < 0.15, key
            assert float(val.abs().max()) <= 2 * float(np.abs(want).max()), key


# ----------------------------------------------------------- Jamba smoke, whole
def both(seed=0):
    jp = JM.init_params(jax.random.key(seed), j_smoke(ARCH))
    cfg = get_smoke_config(ARCH)
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")


@pytest.fixture(scope="module")
def jamba():
    return both()


def tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(1, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "naive"])
def test_forward_and_loss_match(jamba, use_kernel):
    """Mamba, attention (K4's plain version against the JAX kernel path, or
    both naive) and the MoE's aux loss, at a ragged length."""
    cfg, jp, tp = jamba
    tok = tokens(cfg, 2, 37, 4)
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(tok)}
    tb = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(tok)}
    jl, jaux, jh = JM.forward_train(jp, jb, j_smoke(ARCH), use_kernel=use_kernel)
    tl, taux, th = TM.forward_train(tp, tb, cfg, use_kernel=use_kernel)
    close(tl, jl, MODEL_TOL)
    close(th, jh, MODEL_TOL)
    close(taux, jaux, MODEL_TOL)
    assert float(taux) > 0
    jloss, jm = JM.loss_fn(jp, jb, j_smoke(ARCH), use_kernel=use_kernel)
    tloss, tm = TM.loss_fn(tp, tb, cfg, use_kernel=use_kernel)
    close(tloss, jloss, MODEL_TOL)
    assert set(tm) == set(jm) == {"ce", "moe_aux", "loss"}
    for key in tm:
        close(tm[key], jm[key], MODEL_TOL)


def test_decode_steps_match_with_every_state(jamba):
    """4 decode steps at per-slot positions: logits, the attention layer's
    KV cache and every Mamba layer's conv window and SSM state."""
    cfg, jp, tp = jamba
    B, max_seq = 3, 16
    jc = JM.init_cache(j_smoke(ARCH), B, max_seq, dtype=jnp.float32)
    tc = TM.init_cache(cfg, B, max_seq, dtype=torch.float32, device="cpu")
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
    kinds = TT.layer_kinds(cfg)
    assert [mixer for mixer, _ in kinds] == ["attn"] + ["mamba"] * 7
    for layer_, (tcache, (mixer, _)) in enumerate(zip(tc["stack"], kinds)):
        jcache = jc["stack"][layer_]  # one group: layer l is member l
        assert set(tcache) == set(jcache) == ({"k", "v"} if mixer == "attn" else {"conv", "ssm"})
        for key in tcache:
            close(tcache[key], jcache[key][0], MODEL_TOL)


def test_decode_matches_the_forward_at_the_last_prompt_token(jamba):
    cfg, _, tp = jamba
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
    """Each request alone in a new JAX engine: a slot that took no step
    before it (the engines share one compiled step)."""
    outs, step = [], None
    for p in prompt_list:
        eng = JEngine(j_smoke(ARCH), jp, batch_slots=slots, max_seq=max_seq)
        eng._step = step or eng._step
        step = eng._step
        outs.extend(serve_loop(eng, JRequest, [p], max_new))
    return outs


def test_engine_matches_the_jax_engine_on_fresh_slots(jamba):
    """4 slots, 4 requests: no slot is reused. Each request's tokens are the
    JAX engine's on a fresh slot, and the bookkeeping (steps, tokens,
    positions) is the JAX engine's driven by the same script. The JAX
    engine's own tokens differ after request 0: its free slots step with
    the batch, and their recurrent states carry into their first request."""
    cfg, jp, tp = jamba
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


def test_a_reused_slot_gives_a_fresh_engines_tokens(jamba):
    """The departure: one slot serves requests A, then B, then C. The port
    gives each the tokens of a fresh engine, the JAX engine's on a fresh
    slot; the JAX engine's own B and C carry A's state and differ."""
    cfg, jp, tp = jamba
    ps = prompts(5, 3)
    fresh = jax_fresh_tokens(jp, ps, 1, 64, 6)
    assert serve_loop(TEngine(cfg, tp, batch_slots=1, max_seq=64, device="cpu"), TRequest, ps,
                      6) == fresh
    leaked = serve_loop(JEngine(j_smoke(ARCH), jp, batch_slots=1, max_seq=64), JRequest, ps, 6)
    assert leaked[0] == fresh[0] and leaked[1:] != fresh[1:]


def test_admit_resets_only_the_recurrent_states(jamba):
    cfg, _, tp = jamba
    eng = TEngine(cfg, tp, batch_slots=2, max_seq=16, device="cpu")
    eng.admit(TRequest(rid=0, prompt=np.asarray([5, 9, 42], np.int32), max_new_tokens=1))
    eng.run_to_completion()
    before = [{key: t.clone() for key, t in state.items()} for state in eng.cache["stack"]]
    eng.admit(TRequest(rid=1, prompt=np.asarray([7], np.int32), max_new_tokens=1))
    for state, old, (mixer, _) in zip(eng.cache["stack"], before, TT.layer_kinds(cfg)):
        for key, t in state.items():
            if mixer == "attn":
                assert torch.equal(t, old[key])
            else:
                assert not t[0].any() and torch.equal(t[1], old[key][1])
                assert old[key][0].any()

