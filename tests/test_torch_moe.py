"""The port's single-card MoE layer and the Mixtral model path against the
JAX package, on the CPU.

No sharding rules are active on the JAX side, so its ``moe_apply_auto``
takes ``moe_apply_sparse``, as on one card. Weights are the JAX package's
(``moe_init`` or ``init_params``) carried across as numpy arrays; inputs
are made by numpy from a seed. Everything runs in float32. Tolerances:
the expert ids are equal exactly, and so are the capacity drops; a layer's
outputs, gates and aux loss within rtol = atol = 1e-5 (``LAYER_TOL``: the
same products and sums in another order); whole forwards, losses and
decode logits within 1e-4 (``MODEL_TOL`` of ``test_torch_models.py``,
across the layers of the smoke config).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as j_smoke
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import moe as JMOE

from repro_torch.configs import get_smoke_config
from repro_torch.dist import sharding as SH
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models.convert import params_from_jax

LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
ARCH = "mixtral-8x7b"


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def moe_cfgs(shared=0, capacity_factor=None):
    """(JAX, port) Mixtral smoke configs, with shared experts or another
    capacity factor if asked."""
    jcfg, tcfg = j_smoke(ARCH), get_smoke_config(ARCH)
    changes = {"shared_experts": shared}
    if capacity_factor is not None:
        changes["capacity_factor"] = capacity_factor
    return (dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **changes)),
            dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, **changes)))


def layer(jcfg, seed=0, zero_router=False):
    """One MoE layer's JAX parameters and the same tensors for the port."""
    jp = JMOE.moe_init(jax.random.key(seed), jcfg, jnp.float32)
    if zero_router:
        jp["router"] = jnp.zeros_like(jp["router"])
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jp, tp


def hidden(B, S, d, seed):
    x = np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


# ------------------------------------------------------------------ router
@pytest.mark.parametrize("norm", [True, False])
def test_router_topk_matches(norm):
    logits = np.random.default_rng(0).standard_normal((37, 8)).astype(np.float32) * 2
    jw, jidx = JMOE.router_topk(jnp.asarray(logits), 2, norm)
    tw, tidx = TMOE.router_topk(torch.from_numpy(logits), 2, norm)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    close(tw, jw, LAYER_TOL)


def test_router_ties_take_the_lower_expert_first():
    """A router of zeros makes every probability equal: lax.top_k gives
    experts [0, 1] on every token, and so must the port, through the layer
    as well as the router."""
    jcfg, tcfg = moe_cfgs()
    jp, tp = layer(jcfg, seed=1, zero_router=True)
    jx, tx = hidden(2, 8, tcfg.d_model, 2)
    jlog = jnp.asarray(jx.reshape(16, -1) @ jp["router"])
    _, jidx = JMOE.router_topk(jlog, 2, True)
    _, tidx = TMOE.router_topk(torch.zeros(16, tcfg.moe.num_experts), 2, True)
    assert np.asarray(jidx).tolist() == [[0, 1]] * 16
    assert tidx.tolist() == [[0, 1]] * 16
    with TMOE.recording_routes() as routes:
        ty, taux = TMOE.moe_apply_sparse(tp, tx, tcfg)
    assert routes[0][0].tolist() == [[0, 1]] * 16
    jy, jaux = JMOE.moe_apply_sparse(jp, jx, jcfg)
    close(ty, jy, LAYER_TOL)
    close(taux, jaux, LAYER_TOL)


def test_load_balance_loss_matches():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((50, 4)).astype(np.float32)
    idx = np.stack([rng.permutation(4)[:2] for _ in range(50)]).astype(np.int32)
    close(TMOE.load_balance_loss(torch.from_numpy(logits), torch.from_numpy(idx).long(), 4, 2),
          JMOE.load_balance_loss(jnp.asarray(logits), jnp.asarray(idx), 4, 2), LAYER_TOL)


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("shared", [0, 1], ids=["routed", "shared"])
def test_dense_dispatch_matches(shared):
    jcfg, tcfg = moe_cfgs(shared=shared)
    jp, tp = layer(jcfg, seed=4)
    assert ("shared" in tp) == bool(shared)
    jx, tx = hidden(2, 12, tcfg.d_model, 5)
    jy, jaux = JMOE.moe_apply(jp, jx, jcfg)
    ty, taux = TMOE.moe_apply(tp, tx, tcfg)
    close(ty, jy, LAYER_TOL)
    close(taux, jaux, LAYER_TOL)


@pytest.mark.parametrize("shared", [0, 1], ids=["routed", "shared"])
@pytest.mark.parametrize("cf,drops", [(8.0, False), (0.5, True)], ids=["smoke_cf8", "cf0.5_drops"])
def test_sparse_dispatch_matches(cf, drops, shared):
    """The smoke config's capacity factor of 8 drops nothing; 0.5 on 128
    tokens (C = 32 slots for 64 entries an expert on average) drops some,
    and the port drops the same (token, k) entries."""
    jcfg, tcfg = moe_cfgs(shared=shared, capacity_factor=cf)
    jp, tp = layer(jcfg, seed=6)
    jx, tx = hidden(2, 64, tcfg.d_model, 7)
    assert TMOE.capacity(tcfg, 128) == (512 if cf == 8.0 else 32)
    jy, jaux = JMOE.moe_apply_sparse(jp, jx, jcfg)
    with TMOE.recording_routes() as routes:
        ty, taux = TMOE.moe_apply_sparse(tp, tx, tcfg)
    (idx, keep, logits), = routes
    assert bool((~keep).any()) == drops
    close(ty, jy, LAYER_TOL)
    close(taux, jaux, LAYER_TOL)
    # the same drops: the port routes as the JAX package does, and keeps
    # the entries whose running count in their expert is under C
    jlogits = jx.reshape(128, -1) @ jp["router"]
    close(logits, jlogits, LAYER_TOL)
    _, jidx = JMOE.router_topk(jlogits, 2, True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    counts = np.zeros(tcfg.moe.num_experts, int)
    want_keep = []
    for e in np.asarray(jidx).reshape(-1):
        want_keep.append(counts[e] < TMOE.capacity(tcfg, 128))
        counts[e] += 1
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_keep))


def test_sparse_dispatch_with_a_capacity_argument():
    jcfg, tcfg = moe_cfgs()
    jp, tp = layer(jcfg, seed=8)
    jx, tx = hidden(1, 96, tcfg.d_model, 9)
    jy, _ = JMOE.moe_apply_sparse(jp, jx, jcfg, capacity_factor=0.25)
    ty, _ = TMOE.moe_apply_sparse(tp, tx, tcfg, capacity_factor=0.25)
    close(ty, jy, LAYER_TOL)


def test_auto_takes_the_sparse_dispatch_on_one_card():
    jcfg, tcfg = moe_cfgs(capacity_factor=0.5)
    jp, tp = layer(jcfg, seed=10)
    jx, tx = hidden(2, 64, tcfg.d_model, 11)
    ty, taux = TMOE.moe_apply_auto(tp, tx, tcfg)
    sy, saux = TMOE.moe_apply_sparse(tp, tx, tcfg)
    assert torch.equal(ty, sy) and torch.equal(taux, saux)
    jy, jaux = JMOE.moe_apply_auto(jp, jx, jcfg)
    close(ty, jy, LAYER_TOL)
    close(taux, jaux, LAYER_TOL)
    # under rules whose token split is uneven (126 tokens of the rank's data
    # shard over a model axis of 4) the shard takes the sparse dispatch too
    SH.set_active(SH.ShardRules(), ProcessMesh(("data", "model"), (3, 4)))
    try:
        odd = tx[:, :63]
        assert torch.equal(TMOE.moe_apply_auto(tp, odd, tcfg)[0],
                           TMOE.moe_apply_sparse(tp, odd, tcfg)[0])
    finally:
        SH.clear_active()


# ------------------------------------------------------------- whole model
@pytest.fixture(scope="module")
def mixtral():
    jcfg, cfg = j_smoke(ARCH), get_smoke_config(ARCH)
    jp = JM.init_params(jax.random.key(0), jcfg)
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def tokens_batch(cfg, B, S, seed):
    tokens = np.random.default_rng(seed).integers(1, cfg.vocab, (B, S)).astype(np.int32)
    return ({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)},
            {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(tokens)})


def test_params_from_jax_carries_the_experts(mixtral):
    jcfg, cfg, jp, tp = mixtral
    assert len(tp["stack"]) == cfg.n_layers
    (member,) = jp["stack"]
    for layer_ in range(cfg.n_layers):
        ffn = tp["stack"][layer_]["ffn"]
        assert set(ffn) == {"router", "w_in", "w_gate", "w_out"}
        for key, val in ffn.items():
            np.testing.assert_array_equal(val.numpy(), np.asarray(member["ffn"][key][layer_]))
    again = TM.init_params(0, cfg, device="cpu")
    assert {k: v.shape for k, v in again["stack"][0]["ffn"].items()} == \
        {k: v.shape for k, v in tp["stack"][0]["ffn"].items()}


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "naive"])
def test_mixtral_forward_aux_and_loss_match(mixtral, use_kernel):
    """40 tokens: the smoke config's window of 32 binds."""
    jcfg, cfg, jp, tp = mixtral
    jb, tb = tokens_batch(cfg, 2, 40, 12)
    jl, jaux, jh = JM.forward_train(jp, jb, jcfg, use_kernel=use_kernel)
    tl, taux, th = TM.forward_train(tp, tb, cfg, use_kernel=use_kernel)
    assert tl.shape == (2, 40, cfg.vocab) and taux.dtype == torch.float32
    assert float(taux) > 0
    close(tl, jl, MODEL_TOL)
    close(th, jh, MODEL_TOL)
    close(taux, jaux, MODEL_TOL)
    jloss, jm = JM.loss_fn(jp, jb, jcfg, use_kernel=use_kernel)
    tloss, tm = TM.loss_fn(tp, tb, cfg, use_kernel=use_kernel)
    assert set(tm) == set(jm) == {"ce", "moe_aux", "loss"}
    close(tloss, jloss, MODEL_TOL)
    for key in jm:
        close(tm[key], jm[key], MODEL_TOL)
    assert float(tloss) == pytest.approx(float(tm["ce"]) + cfg.moe.aux_loss_weight
                                         * float(tm["moe_aux"]), rel=1e-6)


def test_mixtral_routes_are_the_jax_packages(mixtral):
    """Layer by layer, the port routes every token to the JAX package's
    experts: the hidden state entering each MoE layer is the reference's
    within the model tolerance, and no route flips."""
    jcfg, cfg, jp, tp = mixtral
    jb, tb = tokens_batch(cfg, 2, 40, 13)
    with TMOE.recording_routes() as routes:
        TM.forward_train(tp, tb, cfg)
    assert len(routes) == cfg.n_layers
    x = JM._embed_inputs(jp, jb, jcfg)[0]
    positions = jnp.broadcast_to(jnp.arange(40, dtype=jnp.int32), (2, 40))
    (member,) = jp["stack"]
    for layer_, (idx, keep, _) in enumerate(routes):
        params = jax.tree.map(lambda a: a[layer_], member)
        h = x + JA.gqa_train(params["mixer"], JM._norm_f(jcfg)(params["norm1"], x), jcfg,
                             positions)
        h2 = JM._norm_f(jcfg)(params["norm2"], h)
        _, jidx = JMOE.router_topk(h2.reshape(80, -1) @ params["ffn"]["router"], 2, True)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        assert bool(keep.all())  # the smoke config's capacity factor of 8 drops nothing
        x = h + JMOE.moe_apply_sparse(params["ffn"], h2, jcfg)[0]


def test_mixtral_decode_steps_match(mixtral):
    """Several decode steps at per-slot positions, past the window, the KV
    cache carried from step to step on both sides; the MoE layers' aux is
    dropped in decode form on both."""
    jcfg, cfg, jp, tp = mixtral
    B, max_seq = 3, 48
    jc = JM.init_cache(jcfg, B, max_seq, dtype=jnp.float32)
    tc = TM.init_cache(cfg, B, max_seq, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(14)
    pos = np.array([0, 20, 33], np.int32)
    for _ in range(6):
        tok = rng.integers(1, cfg.vocab, B).astype(np.int32)
        jlog, jc = JM.decode_step(jp, jc, {"token": jnp.asarray(tok)}, jnp.asarray(pos), jcfg)
        tlog, tc = TM.decode_step(tp, tc, {"token": torch.from_numpy(tok)},
                                  torch.from_numpy(pos.copy()), cfg)
        close(tlog, jlog, MODEL_TOL)
        pos = pos + 1


def test_mixtral_decode_matches_its_forward(mixtral):
    """Feeding a prompt token by token through the cache gives the
    full-sequence forward's last-token logits (one sequence: the capacity
    drops nothing at cf 8)."""
    _, cfg, _, tp = mixtral
    prompt = np.random.default_rng(15).integers(1, cfg.vocab, 11).astype(np.int32)
    cache = TM.init_cache(cfg, 1, 16, dtype=torch.float32, device="cpu")
    for i, tok in enumerate(prompt):
        logits, cache = TM.decode_step(tp, cache, {"token": torch.tensor([tok])}, i, cfg)
    full = TM.forward_train(tp, {"tokens": torch.from_numpy(prompt)[None]}, cfg)[0]
    close(logits[0], full[0, -1], MODEL_TOL)
