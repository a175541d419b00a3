"""The model path of the port against the JAX package, on the CPU.

Parameters come from the JAX package's ``init_params`` and are carried
across by ``models.convert.params_from_jax``; inputs are made by numpy from
a seed. Every comparison is in float32 on the smoke configs: layers within
rtol = atol = 1e-5, whole forwards, losses and decode logits within 1e-4
(products and sums run in another order in the two frameworks, across a
few layers). The port's ``use_kernel=True`` (the flash kernel's plain
version on the CPU) is held against the JAX package's ``use_kernel=True``
(its chunked online-softmax path on the CPU, the same recurrence), and
``use_kernel=False`` against its naive oracle.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as j_smoke
from repro.models import layers as JL
from repro.models import model as JM

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax

LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
DENSE = ["tinyllama-1.1b", "olmo-1b", "phi3-mini-3.8b", "llama3-405b", "qwen2-vl-7b",
         "musicgen-large"]


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def both(arch, seed=0):
    """The arch's smoke config and its JAX parameters on both sides."""
    jp = JM.init_params(jax.random.key(seed), j_smoke(arch))
    cfg = get_smoke_config(arch)
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def batch_for(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}, \
        {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(tokens)}
    if cfg.embeds_input:
        emb = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        jb["embeds"], tb["embeds"] = jnp.asarray(emb), torch.from_numpy(emb)
    if cfg.rope == "mrope":
        pos = np.stack([np.broadcast_to(np.arange(S), (B, S)),
                        np.broadcast_to(np.arange(S) // 2, (B, S)),
                        np.broadcast_to(np.arange(S) % 3, (B, S))]).astype(np.int32)
        jb["mrope_positions"], tb["mrope_positions"] = jnp.asarray(pos), torch.from_numpy(pos)
    return jb, tb


# ------------------------------------------------------------------ configs
def test_configs_are_the_jax_packages():
    from repro.configs import ARCH_IDS as J_IDS, get_config as j_config
    assert ARCH_IDS == J_IDS
    for arch in ARCH_IDS:
        for ours, theirs in ((get_config(arch), j_config(arch)),
                             (get_smoke_config(arch), j_smoke(arch))):
            assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
            assert ours.param_count() == theirs.param_count()
            assert ours.layer_kinds() == theirs.layer_kinds()
    cfg = get_config("tinyllama-1.1b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab, cfg.param_dtype) == (22, 2048, 32, 4, 64, 5632, 32000, "bfloat16")


# ------------------------------------------------------------------- layers
def test_norms_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    tx = torch.from_numpy(x)
    close(TL.rmsnorm({"scale": torch.from_numpy(scale)}, tx),
          JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)), LAYER_TOL)
    close(TL.layernorm({"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}, tx),
          JL.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, jnp.asarray(x)),
          LAYER_TOL)
    close(TL.layernorm({}, tx), JL.layernorm({}, jnp.asarray(x)), LAYER_TOL)
    got = TL.rmsnorm({"scale": torch.ones(16, dtype=torch.bfloat16)}, tx.bfloat16())
    assert got.dtype == torch.bfloat16  # computed in float32, cast back


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope_matches(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32) * 5, (2, 7))
    close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(pos)), theta),
          JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), LAYER_TOL)


def test_mrope_matches():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 50, (3, 2, 7)).astype(np.int32)
    close(TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), (4, 2, 2)),
          JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), (4, 2, 2)), LAYER_TOL)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_and_embeddings_match(gated):
    rng = np.random.default_rng(3)
    p = {"w_in": rng.standard_normal((8, 12)), "w_out": rng.standard_normal((12, 8))}
    if gated:
        p["w_gate"] = rng.standard_normal((8, 12))
    p = {key: val.astype(np.float32) / 3 for key, val in p.items()}
    x = rng.standard_normal((2, 5, 8)).astype(np.float32)
    tp = {key: torch.from_numpy(val) for key, val in p.items()}
    jp = {key: jnp.asarray(val) for key, val in p.items()}
    act = (torch.nn.functional.silu, jax.nn.silu) if gated else (TL.gelu, jax.nn.gelu)
    close(TL.mlp_apply(tp, torch.from_numpy(x), act[0]), JL.mlp_apply(jp, jnp.asarray(x), act[1]),
          LAYER_TOL)
    table = rng.standard_normal((11, 8)).astype(np.float32)
    tokens = rng.integers(0, 11, (2, 5)).astype(np.int32)
    close(TL.embed_apply({"table": torch.from_numpy(table)}, torch.from_numpy(tokens)),
          JL.embed_apply({"table": jnp.asarray(table)}, jnp.asarray(tokens)), 0)
    close(TL.unembed_apply({"table": torch.from_numpy(table)}, torch.from_numpy(x)),
          JL.unembed_apply({"table": jnp.asarray(table)}, jnp.asarray(x)), LAYER_TOL)


def test_init_scales_follow_the_jax_package():
    gen = torch.Generator().manual_seed(0)
    w = TL.truncated_normal(gen, (256, 512), torch.float32, 0.5, "cpu")
    assert float(w.abs().max()) <= 1.0 and abs(float(w.std()) - 0.5 * 0.8796) < 0.01
    cfg = get_smoke_config("tinyllama-1.1b")
    params = TM.init_params(0, cfg, device="cpu")
    flat = {**params["stack"][0]["mixer"], **params["stack"][0]["ffn"]}
    assert set(flat) == {"wq", "wk", "wv", "wo", "w_in", "w_out", "w_gate"}
    assert len(params["stack"]) == cfg.n_layers
    again = TM.init_params(0, cfg, device="cpu")
    assert torch.equal(params["embed"]["table"], again["embed"]["table"])


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "naive"])
def test_forward_and_loss_match(arch, use_kernel):
    cfg, jp, tp = both(arch)
    jb, tb = batch_for(cfg, 2, 16, 4)
    jl, _, jh = JM.forward_train(jp, jb, j_smoke(arch), use_kernel=use_kernel)
    tl, aux, th = TM.forward_train(tp, tb, cfg, use_kernel=use_kernel)
    assert tl.shape == (2, 16, cfg.vocab) and float(aux) == 0.0
    close(tl, jl, MODEL_TOL)
    close(th, jh, MODEL_TOL)
    jloss, _ = JM.loss_fn(jp, jb, j_smoke(arch), use_kernel=use_kernel)
    tloss, metrics = TM.loss_fn(tp, tb, cfg, use_kernel=use_kernel)
    close(tloss, jloss, MODEL_TOL)
    assert metrics["ce"] is tloss


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmo-1b", "mixtral-8x7b", "deepseek-v3-671b"])
def test_kernel_and_naive_forwards_agree(arch):
    cfg = get_smoke_config(arch)
    if cfg.moe is not None:  # mixtral's window and deepseek's MLA, on dense stacks
        cfg = dataclasses.replace(cfg, moe=None, family="dense")
    params = TM.init_params(1, cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(5).integers(1, cfg.vocab, (2, 48)).astype(np.int32))}
    a = TM.forward_train(params, batch, cfg, use_kernel=True)[0]
    b = TM.forward_train(params, batch, cfg, use_kernel=False)[0]
    close(a, b, MODEL_TOL)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmo-1b", "qwen2-vl-7b", "deepseek-v3-671b"])
def test_decode_steps_match(arch):
    """Several decode steps at per-slot positions, the KV cache (MLA's
    latent cache, and the dense prefix's) carried from step to step on
    both sides."""
    cfg, jp, tp = both(arch, seed=2)
    B, max_seq = 3, 16
    jc = JM.init_cache(j_smoke(arch), B, max_seq, dtype=jnp.float32)
    tc = TM.init_cache(cfg, B, max_seq, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(6)
    pos = np.array([0, 3, 7], np.int32)
    for _ in range(4):
        if cfg.embeds_input:
            emb = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
            jb, tb = {"embed": jnp.asarray(emb)}, {"embed": torch.from_numpy(emb)}
        else:
            tok = rng.integers(1, cfg.vocab, B).astype(np.int32)
            jb, tb = {"token": jnp.asarray(tok)}, {"token": torch.from_numpy(tok)}
        if cfg.rope == "mrope":
            mp = np.broadcast_to(pos[None, :, None], (3, B, 1)).astype(np.int32)
            jb["mrope_positions"], tb["mrope_positions"] = jnp.asarray(mp), torch.from_numpy(mp)
        jlog, jc = JM.decode_step(jp, jc, jb, jnp.asarray(pos), j_smoke(arch))
        tlog, tc = TM.decode_step(tp, tc, tb, torch.from_numpy(pos.copy()), cfg)
        close(tlog, jlog, MODEL_TOL)
        pos = pos + 1
    assert set(tc) == set(jc)
    for part in tc:  # one member per group: layer l is group l
        (jcache,) = jc[part]
        for layer, tcache in enumerate(tc[part]):
            assert set(tcache) == set(jcache) == ({"c_kv", "k_rope"} if cfg.attention == "mla"
                                                  else {"k", "v"})
            for key in tcache:
                close(tcache[key], jcache[key][layer], MODEL_TOL)


def test_decode_matches_the_forward_at_the_last_prompt_token():
    """The serving path and the prefill path compute the same model: decode
    logits after feeding a prompt token by token equal forward_train's
    last-token logits."""
    cfg = get_smoke_config("tinyllama-1.1b")
    params = TM.init_params(3, cfg, device="cpu")
    prompt = np.random.default_rng(7).integers(1, cfg.vocab, 9).astype(np.int32)
    cache = TM.init_cache(cfg, 1, 16, dtype=torch.float32, device="cpu")
    for i, tok in enumerate(prompt):
        logits, cache = TM.decode_step(params, cache, {"token": torch.tensor([tok])}, i, cfg)
    full = TM.forward_train(params, {"tokens": torch.from_numpy(prompt)[None]}, cfg)[0]
    close(logits[0], full[0, -1], MODEL_TOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_builds_on_the_cpu(arch):
    """Every arch of the registry has its parameters and its decode cache,
    one entry per layer of the main stack."""
    cfg = get_smoke_config(arch)
    params = TM.init_params(0, cfg, device="cpu")
    cache = TM.init_cache(cfg, 2, 8, device="cpu")
    n_stack = cfg.n_layers - cfg.first_dense_layers
    assert len(params["stack"]) == len(cache["stack"]) == n_stack
    assert len(params.get("prefix", [])) == cfg.first_dense_layers


def test_no_member_kind_is_refused():
    """No model module refuses an arch or a rule as not ported: no
    ``NotImplementedError`` there (``member_train`` runs
    ``ShardRules.seq_parallel`` since the dense layers are
    tensor-parallel)."""
    import pathlib
    import repro_torch.models as pkg
    for path in pathlib.Path(pkg.__file__).parent.glob("*.py"):
        assert "NotImplementedError" not in path.read_text(), path
