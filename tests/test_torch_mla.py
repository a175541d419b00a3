"""DeepSeek-V3's model path in the port against the JAX package, on the CPU:
MLA (latent attention), the dense prefix and the MTP head.

Parameters come from the JAX package's ``init_params`` and are carried
across by ``models.convert.params_from_jax``; inputs are made by numpy from
a seed. Every comparison is in float32 on DeepSeek smoke (qk head dim 24 =
16 + 8, v head dim 16, one dense prefix layer, two MoE layers, the MTP
block): the MLA layer and its decode within rtol = atol = 1e-5, K4's plain
version against the Pallas kernel at the same tiles within 1e-5, whole
forwards, losses and decode logits within 1e-4 (products and sums run in
another order in the two frameworks, across a few layers), and the
engine's greedy tokens equal. The port's ``use_kernel=True`` hands K4 v at
its own head dim, where the JAX package pads v to q's head dim for its
kernel and slices the output back.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as j_smoke
from repro.kernels.flash_attention.flash_attention import flash_attention as j_flash
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.serve.engine import Engine as JEngine, Request as JRequest

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention, flash_attention_plain)
from repro_torch.launch import serve as t_serve
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.engine import Engine as TEngine, Request as TRequest

ARCH = "deepseek-v3-671b"
LAYER_TOL = 1e-5
MODEL_TOL = 1e-4


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def deepseek():
    jcfg, cfg = j_smoke(ARCH), get_smoke_config(ARCH)
    jp = JM.init_params(jax.random.key(0), jcfg)
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def tokens_batch(cfg, B, S, seed):
    tokens = np.random.default_rng(seed).integers(1, cfg.vocab, (B, S)).astype(np.int32)
    return ({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)},
            {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(tokens)})


def _mixers(deepseek):
    """The first MoE layer's MLA parameters on both sides."""
    jcfg, cfg, jp, tp = deepseek
    (member,) = jp["stack"]
    return jcfg, cfg, jax.tree.map(lambda a: a[0], member)["mixer"], tp["stack"][0]["mixer"]


# -------------------------------------------------------------- the layer
@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "naive"])
def test_mla_train_matches(deepseek, use_kernel):
    jcfg, cfg, jmix, tmix = _mixers(deepseek)
    B, S = 2, 40
    x = np.random.default_rng(1).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want = JA.mla_train(jmix, jnp.asarray(x), jcfg, jnp.asarray(pos), use_kernel=use_kernel)
    got = TA.mla_train(tmix, torch.from_numpy(x), cfg, torch.from_numpy(pos.copy()),
                       use_kernel=use_kernel)
    assert got.shape == (B, S, cfg.d_model)
    close(got, want, LAYER_TOL)


def test_mla_kernel_and_naive_paths_agree(deepseek):
    _, cfg, _, tmix = _mixers(deepseek)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 70, cfg.d_model))
                         .astype(np.float32))
    pos = torch.arange(70, dtype=torch.int32)[None]
    close(TA.mla_train(tmix, x, cfg, pos, use_kernel=True),
          TA.mla_train(tmix, x, cfg, pos, use_kernel=False).numpy(), LAYER_TOL)


def test_mla_decode_matches(deepseek):
    """Several steps at per-slot positions, the latent cache carried from
    step to step on both sides; the port writes it in place."""
    jcfg, cfg, jmix, tmix = _mixers(deepseek)
    B, max_seq = 3, 16
    jc = JA.mla_cache_init(jcfg, B, max_seq, jnp.float32)
    tc = TA.mla_cache_init(cfg, B, max_seq, torch.float32, "cpu")
    rng = np.random.default_rng(3)
    pos = np.array([0, 4, 9], np.int32)
    for _ in range(5):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        jy, jc = JA.mla_decode(jmix, jnp.asarray(x), jc, jcfg, jnp.asarray(pos))
        ty, same = TA.mla_decode(tmix, torch.from_numpy(x), tc, cfg, torch.from_numpy(pos.copy()))
        assert same is tc
        close(ty, jy, LAYER_TOL)
        pos = pos + 1
    for key in ("c_kv", "k_rope"):
        close(tc[key], jc[key], LAYER_TOL)


def test_mla_decode_takes_a_float32_cache_with_bf16_weights():
    """The engine's cache is float32 and the weights bf16: the latent's
    expansion runs in float32 (JAX promotes; torch would raise on the
    mixed product), and the output keeps the activations' dtype."""
    cfg = get_smoke_config(ARCH)
    params = TA.mla_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16, "cpu")
    cache = TA.mla_cache_init(cfg, 2, 8, torch.float32, "cpu")
    x = torch.randn(2, 1, cfg.d_model).to(torch.bfloat16)
    y, cache = TA.mla_decode(params, x, cache, cfg, torch.tensor([0, 3]))
    assert y.dtype == torch.bfloat16 and cache["c_kv"].dtype == torch.float32
    assert bool(cache["c_kv"][1, 3].any()) and not bool(cache["c_kv"][1, 2].any())


# ------------------------------------------------------------ K4 at MLA's dims
@pytest.mark.parametrize("d,dv", [(24, 16), (192, 128)], ids=["smoke", "deepseek-v3"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_at_mla_head_dims_matches_pallas(d, dv, causal):
    """K4's plain version with v at its own head dim against the Pallas
    kernel in interpret mode on v padded with zeros to q's head dim, as the
    JAX package's ``mla_train`` pads it, and sliced back; the scale is
    1/sqrt(d) on both."""
    rng = np.random.default_rng(4)
    q, k = (rng.standard_normal((3, 128, d)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((3, 128, dv)).astype(np.float32)
    vp = np.pad(v, ((0, 0), (0, 0), (0, d - dv)))
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(vp), causal=causal, bq=64, bk=64,
                   interpret=True)[..., :dv]
    tq, tk, tv = (torch.from_numpy(a)[:, :, None] for a in (q, k, v))
    got = flash_attention_plain(tq, tk, tv, causal=causal, bq=64, bk=64)
    assert got.shape == (3, 128, 1, dv)
    close(got[:, :, 0], want, LAYER_TOL)
    close(flash_attention(tq, tk, tv, causal=causal)[:, :, 0], want, 2e-4)


@pytest.mark.parametrize("d,dv", [(192, 192), (128, 64), (24, 16)], ids=str)
def test_wrapper_refuses_unsupported_head_dim_pairs(d, dv):
    """Off the CPU the wrapper launches the kernel or raises: a pair the
    kernel has no instance for raises ValueError before anything else."""
    q = torch.empty((1, 64, 2, d), device="meta")
    v = torch.empty((1, 64, 2, dv), device="meta")
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, v)
    x = torch.empty((1, 64, 2, 64), device="meta")  # a pair it takes: two devices are refused
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(x, x, torch.empty((1, 64, 2, 64)))


# ------------------------------------------------------------- the model
def test_params_from_jax_carries_the_prefix_and_mtp(deepseek):
    jcfg, cfg, jp, tp = deepseek
    assert len(tp["prefix"]) == cfg.first_dense_layers
    assert len(tp["stack"]) == cfg.n_layers - cfg.first_dense_layers
    assert set(tp["mtp"]) == {"proj", "norm", "block"}
    (prefix,) = jp["prefix"]
    for i, layer in enumerate(tp["prefix"]):
        np.testing.assert_array_equal(layer["mixer"]["wkv_b"].numpy(),
                                      np.asarray(prefix["mixer"]["wkv_b"][i]))
        assert set(layer["ffn"]) == {"w_in", "w_gate", "w_out"}
    np.testing.assert_array_equal(tp["mtp"]["block"]["mixer"]["wq_b"].numpy(),
                                  np.asarray(jp["mtp"]["block"]["mixer"]["wq_b"]))
    n_jax = sum(a.size for a in jax.tree.leaves(jp))
    n_port = sum(t.numel() for t in _leaves(tp))
    n_mtp = sum(a.size for a in jax.tree.leaves(jp["mtp"]))
    assert n_port == n_jax == cfg.param_count() + n_mtp


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
        return
    for sub in tree.values() if isinstance(tree, dict) else tree:
        yield from _leaves(sub)


def test_init_params_makes_the_prefix_and_mtp(deepseek):
    """The port draws its own DeepSeek parameters with the JAX package's
    shapes; the full config no longer raises (made on the meta device:
    shapes only), its count the config's plus the MTP block's."""
    _, cfg, _, converted = deepseek
    params = TM.init_params(0, cfg, device="cpu")
    shapes = lambda tree: sorted(tuple(t.shape) for t in _leaves(tree))
    for key in ("prefix", "stack", "mtp", "embed", "unembed"):
        assert shapes(params[key]) == shapes(converted[key]), key
    full = get_config(ARCH)
    params = TM.init_params(torch.Generator(), full, device="meta")
    assert (len(params["prefix"]), len(params["stack"])) == (3, 58)
    n_mtp = sum(t.numel() for t in _leaves(params["mtp"]))
    assert sum(t.numel() for t in _leaves(params)) == full.param_count() + n_mtp
    cache = TM.init_cache(full, 1, 4, device="meta")
    assert cache["prefix"][0]["c_kv"].shape == (1, 4, 512) and len(cache["stack"]) == 58


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "naive"])
def test_forward_and_loss_with_mtp_match(deepseek, use_kernel):
    jcfg, cfg, jp, tp = deepseek
    jb, tb = tokens_batch(cfg, 2, 24, 5)
    jl, jaux, jh = JM.forward_train(jp, jb, jcfg, use_kernel=use_kernel)
    tl, taux, th = TM.forward_train(tp, tb, cfg, use_kernel=use_kernel)
    assert tl.shape == (2, 24, cfg.vocab) and float(taux) > 0
    close(tl, jl, MODEL_TOL)
    close(th, jh, MODEL_TOL)
    close(taux, jaux, MODEL_TOL)
    close(TM.mtp_logits(tp, th, tb, cfg, use_kernel), JM.mtp_logits(jp, jh, jb, jcfg, use_kernel),
          MODEL_TOL)
    jloss, jm = JM.loss_fn(jp, jb, jcfg, use_kernel=use_kernel)
    tloss, tm = TM.loss_fn(tp, tb, cfg, use_kernel=use_kernel)
    assert set(tm) == set(jm) == {"ce", "moe_aux", "mtp", "loss"}
    for key in jm:
        close(tm[key], jm[key], MODEL_TOL)
    assert float(tloss) == pytest.approx(float(tm["ce"]) + cfg.moe.aux_loss_weight
                                         * float(tm["moe_aux"]) + 0.3 * float(tm["mtp"]),
                                         rel=1e-6)


def test_loss_without_mtp_depth_has_no_mtp_term(deepseek):
    _, cfg, _, tp = deepseek
    _, tb = tokens_batch(cfg, 1, 8, 6)
    metrics = TM.loss_fn(tp, tb, cfg)[1]
    no_mtp = TM.loss_fn(tp, tb, dataclasses.replace(cfg, mtp_depth=0))[1]
    assert "mtp" in metrics and "mtp" not in no_mtp
    assert float(no_mtp["loss"]) == pytest.approx(float(metrics["loss"])
                                                  - 0.3 * float(metrics["mtp"]), rel=1e-6)


def test_decode_steps_match(deepseek):
    """Several decode steps at per-slot positions through the dense prefix
    and the MoE stack, every latent cache carried on both sides."""
    jcfg, cfg, jp, tp = deepseek
    B, max_seq = 3, 16
    jc = JM.init_cache(jcfg, B, max_seq, dtype=jnp.float32)
    tc = TM.init_cache(cfg, B, max_seq, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(7)
    pos = np.array([0, 3, 7], np.int32)
    for _ in range(4):
        tok = rng.integers(1, cfg.vocab, B).astype(np.int32)
        jlog, jc = JM.decode_step(jp, jc, {"token": jnp.asarray(tok)}, jnp.asarray(pos), jcfg)
        tlog, tc = TM.decode_step(tp, tc, {"token": torch.from_numpy(tok)},
                                  torch.from_numpy(pos.copy()), cfg)
        close(tlog, jlog, MODEL_TOL)
        pos = pos + 1
    (jprefix,), (jstack,) = jc["prefix"], jc["stack"]
    for i, layer in enumerate(tc["prefix"]):
        for key in ("c_kv", "k_rope"):
            close(layer[key], jprefix[key][i], MODEL_TOL)
    for g, layer in enumerate(tc["stack"]):
        for key in ("c_kv", "k_rope"):
            close(layer[key], jstack[key][g], MODEL_TOL)


def test_staged_decode_matches(deepseek):
    """``decode_step_staged`` on both sides, each MoE boundary answered by
    the side's own sparse dispatch: the prefix runs first, the yields are
    the reference's post-norm2 hiddens, the logits its."""
    jcfg, cfg, jp, tp = deepseek
    B = 2
    jc = JM.init_cache(jcfg, B, 8, dtype=jnp.float32)
    tc = TM.init_cache(cfg, B, 8, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(8)
    pos = np.array([0, 2], np.int32)
    for _ in range(3):
        tok = rng.integers(1, cfg.vocab, B).astype(np.int32)
        jgen = JM.decode_step_staged(jp, jc, {"token": jnp.asarray(tok)}, jnp.asarray(pos), jcfg)
        tgen = TM.decode_step_staged(tp, tc, {"token": torch.from_numpy(tok)},
                                     torch.from_numpy(pos.copy()), cfg)
        jy = ty = None
        boundaries = 0
        while True:
            try:
                jffn, jh2 = jgen.send(jy)
            except StopIteration as stop:
                jlog, jc = stop.value
                break
            tffn, th2 = tgen.send(ty)
            close(th2, jh2, MODEL_TOL)
            jy = JMOE.moe_apply_sparse(jffn, jh2, jcfg)[0]
            ty = TMOE.moe_apply_sparse(tffn, th2, cfg)[0]
            boundaries += 1
        with pytest.raises(StopIteration) as stop:
            tgen.send(ty)
        tlog, tc = stop.value.value
        assert boundaries == cfg.n_layers - cfg.first_dense_layers
        close(tlog, jlog, MODEL_TOL)
        pos = pos + 1


def test_decode_matches_the_forward_at_the_last_prompt_token(deepseek):
    """Feeding a prompt token by token through the latent caches gives the
    full-sequence forward's last-token logits (cf 8 drops nothing)."""
    _, cfg, _, tp = deepseek
    prompt = np.random.default_rng(9).integers(1, cfg.vocab, 11).astype(np.int32)
    cache = TM.init_cache(cfg, 1, 16, dtype=torch.float32, device="cpu")
    for i, tok in enumerate(prompt):
        logits, cache = TM.decode_step(tp, cache, {"token": torch.tensor([tok])}, i, cfg)
    full = TM.forward_train(tp, {"tokens": torch.from_numpy(prompt)[None]}, cfg)[0]
    close(logits[0], full[0, -1], MODEL_TOL)


def test_member_dispatch_on_mla():
    """The transformer's member functions take MLA where the config says
    so: its parameters, its latent cache and its forward."""
    cfg = get_smoke_config(ARCH)
    gen = torch.Generator().manual_seed(1)
    member = TT.member_init(gen, cfg, "attn", "mlp", torch.float32, "cpu")
    assert set(member["mixer"]) == {"wq_a", "wq_b", "wkv_a", "wkv_b", "wo", "q_norm", "kv_norm"}
    cache = TT.member_cache_init(cfg, "attn", 2, 8, torch.float32, "cpu")
    assert set(cache) == {"c_kv", "k_rope"}
    x = torch.randn(2, 1, cfg.d_model)
    y, same = TT.member_decode(member, x, cache, cfg, "attn", "mlp", 0, None)
    assert same is cache and y.shape == x.shape
    y, aux = TT.member_train(member, torch.randn(2, 5, cfg.d_model), cfg, "attn", "mlp",
                             torch.arange(5)[None].expand(2, 5), None, True)
    assert y.shape == (2, 5, cfg.d_model) and float(aux) == 0.0


# ------------------------------------------------------------- serving
def test_engines_give_the_same_tokens(deepseek):
    """DeepSeek smoke behind both engines, driven by the launcher's loop
    with its smoke defaults: 4 slots, 6 requests, 12 new tokens."""
    jcfg, cfg, jp, tp = deepseek
    jeng = JEngine(jcfg, jp, batch_slots=4, max_seq=128)
    teng = TEngine(cfg, tp, batch_slots=4, max_seq=128, device="cpu")
    rng = np.random.default_rng(10)
    ps = [rng.integers(1, cfg.vocab, size=rng.integers(3, 9)).astype(np.int32) for _ in range(6)]

    def serve(eng, Request):
        pending = [Request(rid=i, prompt=p, max_new_tokens=12) for i, p in enumerate(ps)]
        submitted, done = list(pending), []
        while pending or eng.slot_req:
            while pending and eng.free_slots:
                eng.admit(pending.pop(0))
            eng.step()
            done.extend(r for r in submitted if r.done and r not in done)
        return [(r.rid, r.out) for r in done]

    assert serve(teng, TRequest) == serve(jeng, JRequest)
    assert (jeng.steps_run, jeng.tokens_out) == (teng.steps_run, teng.tokens_out) \
        and teng.tokens_out == 72


def test_launcher_serves_deepseek_on_the_cpu(capsys):
    steps = t_serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "6",
                          "--max-new", "12"])
    out = capsys.readouterr().out
    assert "completed 6/6 requests" in out and steps > 0
    assert out.count(", 12)") == 6
