"""The multi-tenant fleet (``serve.fleet``), its guest-embedded MoE helpers
(``models.moe.moe_guest_*``, ``guest_expert_ffn``) and the staged decode
(``models.model.decode_step_staged``), against the JAX package's.

* The guest dispatch and combine are host NumPy in both packages: the same
  float32 inputs give the same arrays, bit for bit (with a shared expert,
  whose MLP runs in torch and in XLA, within ``SHARED_TOL``, 1e-6). The
  torch expert FFN is held against the NumPy one and the JAX one within
  ``FFN_TOL`` (rtol = atol = 1e-5: another summation order in float32).
* ``decode_step_staged``, each boundary served with the inline
  ``moe_apply_auto``, gives ``decode_step``'s bits.
* The ``"reference"`` fleet serves the JAX fleet's tokens, token for
  token, on the JAX package's weights carried across by
  ``models.convert.params_from_jax``, with the same steps, replays,
  replayed rounds and tokens out: every case of
  ``tests/test_serve_fleet.py`` (the combined arm against each tenant
  served alone, the time-multiplexed arm, the evict and re-admit drill,
  failure eviction, queued requests, the release of the last tenant),
  except the autotuner's decision, which raises here.
* A ``"torch_dist"`` fleet on 8 gloo ranks (spawned once for the module
  through ``launch.mesh.spawn``; every rank drives the same fleet) serves
  the combined, time-multiplexed and churn cases and each tenant alone:
  the same tokens on every rank, equal to its own solo fleet's and to the
  ``"reference"`` fleet's. Greedy decoding turns float32 logits into
  token ids, so the float order of torch's and NumPy's expert FFN does
  not show at these sizes; the ids are compared exactly.

The module imports no jax at its top: the ranks import it.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch import mesh as LM
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.fleet import TenantFleet

from test_torch_moe_ep import assert_bits, flatten, unflatten

ARCH = "mixtral-8x7b"
PROMPTS = [[5, 6, 7], [9, 10], [3, 4]]
FFN_TOL = 1e-5
SHARED_TOL = 1e-6
TESTS = pathlib.Path(__file__).resolve().parent
ROOT = TESTS.parent


# ------------------------------------------------ the drills, for any fleet
def _state(fleet, reqs):
    return {"out": [list(map(int, r.out)) for r in reqs], "done": [r.done for r in reqs],
            "steps": fleet.steps_run, "replays": fleet.replays,
            "rounds": fleet.rounds_replayed, "tokens_out": fleet.tokens_out}


def solo(make, cfg, params, prompt, n_new):
    fleet = make()
    tid = fleet.admit_model(cfg, params, guest=(1, 2), slots=2)
    req = fleet.submit(tid, prompt, n_new)
    fleet.run_to_completion()
    return _state(fleet, [req])


def drill_combined(make, cfg, params, combined=True):
    fleet = make(combined)
    t0 = fleet.admit_model(cfg, params[0], guest=(1, 2), slots=2)
    t1 = fleet.admit_model(cfg, params[1], guest=(1, 2), slots=2)
    reqs = [fleet.submit(t0, PROMPTS[0], 4), fleet.submit(t1, PROMPTS[1], 4)]
    fleet.run_to_completion()
    return _state(fleet, reqs)


def drill_churn(make, cfg, params):
    fleet = make()
    t0 = fleet.admit_model(cfg, params[0], guest=(1, 2), slots=2)
    t1 = fleet.admit_model(cfg, params[1], guest=(1, 2), slots=2)
    reqs = [fleet.submit(t0, PROMPTS[0], 8), fleet.submit(t1, PROMPTS[1], 8)]
    for _ in range(3):
        fleet.step()
    mid = [len(r.out) for r in reqs]
    plan = fleet.evict(t1)
    t2 = fleet.admit_model(cfg, params[2], guest=(1, 2), slots=2)
    reqs.append(fleet.submit(t2, PROMPTS[2], 6))
    fleet.run_to_completion()
    return {**_state(fleet, reqs), "mid": mid, "plan": (plan.surviving, plan.evicted)}


def drill_failure(make, cfg, params):
    fleet = make()
    t0 = fleet.admit_model(cfg, params[0], guest=(1, 2), slots=2)
    t1 = fleet.admit_model(cfg, params[1], guest=(1, 2), slots=2)
    reqs = [fleet.submit(t0, PROMPTS[0], 4)]
    fleet.step()
    fleet.fail(int(fleet.tenants[t1].embedding.device_map[0]))
    plan = fleet.plan_eviction()
    fleet.run_to_completion()
    return {**_state(fleet, reqs), "plan": (plan.surviving, plan.evicted),
            "seated": sorted(fleet.tenants)}


def drill_queued(make, cfg, params):
    fleet = make()
    tid = fleet.admit_model(cfg, params[0], guest=(1, 2), slots=2)
    reqs = [fleet.submit(tid, p, 3) for p in PROMPTS]  # 3 requests, 2 slots
    fleet.run_to_completion()
    return _state(fleet, reqs)


def drill_release_last(make, cfg, params):
    fleet = make()
    t0 = fleet.admit_model(cfg, params[0], guest=(1, 2), slots=2)
    reqs = [fleet.submit(t0, PROMPTS[0], 2)]
    fleet.run_to_completion()
    done_tokens = fleet.tokens_out
    plan = fleet.evict(t0)
    t1 = fleet.admit_model(cfg, params[1], guest=(1, 2), slots=2)
    reqs.append(fleet.submit(t1, PROMPTS[1], 2))
    fleet.run_to_completion()
    return {**_state(fleet, reqs), "done_tokens": done_tokens,
            "plan": (plan.surviving, plan.programs == {})}


DRILLS = {
    "combined": drill_combined,
    "time_mux": lambda make, cfg, params: drill_combined(make, cfg, params, combined=False),
    "churn": drill_churn,
    "failure": drill_failure,
    "queued": drill_queued,
    "release_last": drill_release_last,
}
#: (tenant, prompt, new tokens) of every tenant served alone
SOLOS = [(0, 0, 4), (1, 1, 4), (0, 0, 8), (2, 2, 6), (0, 0, 3), (0, 1, 3), (0, 2, 3),
         (1, 1, 2)]
#: the drills the gloo ranks run
DIST_DRILLS = ("combined", "time_mux", "churn")


def run_drills(make, cfg, params, drills=DRILLS):
    out = {name: DRILLS[name](make, cfg, params) for name in drills}
    out["solo"] = [solo(lambda: make(True), cfg, params[i], PROMPTS[p], n)
                   for i, p, n in SOLOS]
    return out


# -------------------------------------------- the port's side: a gloo rank
def run_rank(rank, group, layout, params_path):
    """The torch_dist fleet's drills on this rank. Returns host data."""
    with np.load(params_path) as f:
        flat = dict(f)
    cfg = get_smoke_config(ARCH)
    params = [params_from_jax(unflatten(flat, str(i)), cfg, device="cpu") for i in range(3)]

    def make(combined=True):
        return TenantFleet((2, 2), backend="torch_dist", max_seq=32, combined=combined,
                           device="cpu", group=group)

    out = run_drills(make, cfg, params, DIST_DRILLS)
    out["transport"] = str(torch.distributed.get_backend(group))
    return out


# ------------------------------------------------------------------ fixtures
@pytest.fixture(scope="module")
def weights():
    """The JAX package's Mixtral smoke weights from ``jax.random.key(i)``,
    i = 0, 1, 2, as trees of numpy arrays, and their port copies."""
    import jax

    from repro.configs import get_smoke_config as j_smoke
    from repro.models import model as JM

    jcfg, cfg = j_smoke(ARCH), get_smoke_config(ARCH)
    jps = [JM.init_params(jax.random.key(i), jcfg) for i in range(3)]
    trees = [jax.tree.map(np.asarray, p) for p in jps]
    return jps, trees, [params_from_jax(t, cfg, device="cpu") for t in trees]


@pytest.fixture(scope="module")
def jax_drills(weights):
    from repro.configs import get_smoke_config as j_smoke
    from repro.serve.fleet import TenantFleet as JFleet

    jps, _, _ = weights
    return run_drills(lambda combined=True: JFleet((2, 2), max_seq=32, combined=combined),
                      j_smoke(ARCH), jps)


@pytest.fixture(scope="module")
def port_drills(weights):
    _, _, tps = weights
    return run_drills(lambda combined=True: TenantFleet((2, 2), max_seq=32, combined=combined,
                                                         device="cpu"),
                      get_smoke_config(ARCH), tps)


@pytest.fixture(scope="module")
def dist_ranks(weights, tmp_path_factory):
    _, trees, _ = weights
    flat = {}
    for i, tree in enumerate(trees):
        flatten(tree, str(i), flat)
    path = tmp_path_factory.mktemp("fleet") / "params.npz"
    np.savez(path, **flat)
    return LM.spawn(run_rank, 8, device="cpu", args=(str(path),))


# ------------------------------------------------ the guest-embedded helpers
#: name -> (tokens (B, S), capacity factor, shared experts)
GUEST_CASES = {"decode": ((2, 1), None, 0), "prefill": ((4, 8), None, 0),
               "drop": ((4, 8), 0.25, 0), "shared": ((2, 3), None, 1)}


def _guest_case(name):
    import jax

    from repro.configs import get_smoke_config as j_smoke
    from repro.models import moe as JMOE

    tokens, cf, shared = GUEST_CASES[name]
    changes = {"shared_experts": shared}
    if cf is not None:
        changes["capacity_factor"] = cf
    jcfg = dataclasses.replace(j_smoke(ARCH), moe=dataclasses.replace(j_smoke(ARCH).moe,
                                                                      **changes))
    cfg = dataclasses.replace(get_smoke_config(ARCH),
                              moe=dataclasses.replace(get_smoke_config(ARCH).moe, **changes))
    import jax.numpy as jnp

    jp = jax.tree.map(np.asarray, JMOE.moe_init(jax.random.key(3), jcfg, jnp.float32))
    tp = {k: ({kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
              if isinstance(v, dict) else torch.from_numpy(np.array(v))) for k, v in jp.items()}
    x = (np.random.default_rng(5).standard_normal((*tokens, cfg.d_model))).astype(np.float32)
    return jcfg, cfg, jp, tp, x


@pytest.mark.parametrize("name", list(GUEST_CASES))
@pytest.mark.parametrize("n_guest", [2, 4])
def test_guest_dispatch_and_combine_equal_the_reference(name, n_guest):
    """The dispatch array and every field of its state bit for bit; the
    combine of the same returned array bit for bit (the shared expert's
    MLP within SHARED_TOL)."""
    from repro.models import moe as JMOE

    jcfg, cfg, jp, tp, x = _guest_case(name)
    jX, js = JMOE.moe_guest_dispatch(jp, x, jcfg, n_guest)
    tX, ts = TMOE.moe_guest_dispatch(tp, torch.from_numpy(x), cfg, n_guest)
    assert_bits(tX, jX)
    for f in dataclasses.fields(js):
        assert_bits(np.asarray(getattr(ts, f.name)), np.asarray(getattr(js, f.name)))
    if name == "drop":
        assert not ts.keep.all()
    back = np.random.default_rng(6).standard_normal(jX.shape).astype(np.float32)
    jy = JMOE.moe_guest_combine(back, js, jp, x)
    ty = TMOE.moe_guest_combine(back, ts, tp, x)
    if GUEST_CASES[name][2]:
        np.testing.assert_allclose(ty, jy, rtol=SHARED_TOL, atol=SHARED_TOL)
    else:
        assert_bits(ty, jy)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_guest_expert_ffn_equals_numpy_and_jax(lead):
    """The torch FFN of one guest device's experts over (..., E_loc, C, d)
    chunks, on its views of the stacks, against the NumPy and JAX FFNs of
    the reference; ``guest_expert_shards`` rows are those views' values."""
    import jax.numpy as jnp

    from repro.models import moe as JMOE

    jcfg, cfg, jp, tp, _ = _guest_case("prefill")
    n_guest, E_loc, C = 2, 2, 16
    chunks = np.random.default_rng(7).standard_normal((*lead, E_loc, C, cfg.d_model))
    chunks = chunks.astype(np.float32)
    shards = TMOE.guest_expert_shards(tp, n_guest)
    jshards = JMOE.guest_expert_shards(jp, n_guest)
    for g in range(n_guest):
        views = TMOE.guest_experts(tp, n_guest, g)
        for key, view, shard, jshard in zip(("w_in", "w_gate", "w_out"), views, shards, jshards):
            assert view.data_ptr() == tp[key][g * E_loc].data_ptr()  # a view, not a copy
            assert_bits(view.numpy(), shard[g])
            assert_bits(shard[g], jshard[g])
        got = TMOE.guest_expert_ffn(torch.from_numpy(chunks), *views).numpy()
        np.testing.assert_allclose(got, TMOE.guest_expert_ffn_np(chunks, *(s[g] for s in shards)),
                                   rtol=FFN_TOL, atol=FFN_TOL)
        want = np.asarray(JMOE.guest_expert_ffn(jnp.asarray(chunks),
                                                *(jnp.asarray(s[g]) for s in jshards)))
        np.testing.assert_allclose(got, want, rtol=FFN_TOL, atol=FFN_TOL)
        assert got.dtype == np.float32


def test_guest_expert_ffn_casts_bf16_weights_to_float32():
    """bf16 weights (as the card holds them) compute in float32, on a
    float32 copy made per call: the same as float32 weights of the same
    values."""
    _, cfg, _, tp, _ = _guest_case("prefill")
    views = TMOE.guest_experts({k: v.to(torch.bfloat16) for k, v in tp.items()}, 2, 1)
    chunks = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(1))
    got = TMOE.guest_expert_ffn(chunks, *views)
    want = TMOE.guest_expert_ffn(chunks, *(v.float() for v in views))
    assert got.dtype == torch.float32 and torch.equal(got, want)


# --------------------------------------------------------- the staged decode
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "tinyllama-1.1b"])
def test_decode_step_staged_with_the_inline_ffn_is_decode_step(arch):
    """Driven with ``moe_apply_auto`` at every boundary, the staged decode
    gives ``decode_step``'s logits and caches bit for bit, step after
    step; a dense model never pauses."""
    cfg = get_smoke_config(arch)
    params = TM.init_params(4, cfg, device="cpu")
    caches = [TM.init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu") for _ in range(2)]
    toks = np.random.default_rng(8).integers(1, cfg.vocab, (5, 2))
    pauses = 0
    for pos, tok in enumerate(toks):
        batch = {"token": torch.from_numpy(tok)}
        want, caches[0] = TM.decode_step(params, caches[0], batch, pos, cfg)
        gen = TM.decode_step_staged(params, caches[1], batch, pos, cfg)
        y = None
        try:
            while True:
                item = next(gen) if y is None else gen.send(y)
                pauses += 1
                y = TMOE.moe_apply_auto(*item, cfg)[0]
        except StopIteration as stop:
            got, caches[1] = stop.value
        assert torch.equal(got, want)
        for a, b in zip(caches[0]["stack"], caches[1]["stack"]):
            assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
    moe_layers = sum(ffn == "moe" for _, ffn in cfg.layer_kinds()) * cfg.n_groups
    assert pauses == len(toks) * moe_layers


# ----------------------------------------------------------- the fleets
@pytest.mark.parametrize("name", list(DRILLS) + ["solo"])
def test_reference_fleet_serves_the_jax_fleets_tokens(jax_drills, port_drills, name):
    """Token for token, with the same steps, replays, replayed rounds and
    tokens out, on the JAX package's weights."""
    assert port_drills[name] == jax_drills[name]


def test_reference_fleet_keeps_the_fleet_contracts(port_drills):
    """What ``tests/test_serve_fleet.py`` asserts of the JAX fleet, of the
    port's: each tenant of the combined arm serves its solo tokens, the
    time-multiplexed arm the same tokens with more replays and rounds,
    the survivor and the re-admitted tenant their solo tokens across the
    churn while the evicted request stays undone, the failure evicts only
    the tenant hit, queued requests drain to their solo tokens."""
    d = port_drills
    solos = [s["out"][0] for s in d["solo"]]
    assert d["combined"]["out"] == solos[:2] and d["combined"]["tokens_out"] == 8
    assert d["time_mux"]["out"] == d["combined"]["out"]
    assert d["time_mux"]["steps"] == d["combined"]["steps"]
    assert d["combined"]["replays"] < d["time_mux"]["replays"]
    assert d["combined"]["rounds"] < d["time_mux"]["rounds"]
    churn = d["churn"]
    assert churn["mid"] == [3, 3] and churn["plan"] == ((0,), (1,))
    assert churn["done"] == [True, False, True]
    assert churn["out"][0] == solos[2] and churn["out"][2] == solos[3]
    assert d["failure"]["plan"] == ((0,), (1,)) and d["failure"]["seated"] == [0]
    assert d["failure"]["out"][0] == solos[0]
    assert d["queued"]["out"] == solos[4:7] and all(d["queued"]["done"])
    rel = d["release_last"]
    assert rel["plan"] == ((), True) and rel["out"][1] == solos[7] and all(rel["done"])


@pytest.mark.parametrize("name", list(DIST_DRILLS) + ["solo"])
def test_torch_dist_fleet_serves_the_reference_fleets_tokens(dist_ranks, port_drills, name):
    """Eight gloo ranks drive the same fleet over ``torch_dist``: every
    rank ends with the ``"reference"`` fleet's tokens, steps, replays and
    rounds."""
    for rank in dist_ranks:
        assert rank[name] == port_drills[name]
        assert rank["transport"] == "gloo"


def test_torch_dist_tenants_serve_their_solo_tokens(dist_ranks):
    """On the ranks, each tenant of the combined arm and each survivor of
    the churn serves what its own solo ``torch_dist`` fleet serves."""
    for rank in dist_ranks:
        solos = [s["out"][0] for s in rank["solo"]]
        assert rank["combined"]["out"] == solos[:2]
        assert rank["time_mux"]["out"] == solos[:2]
        assert rank["churn"]["out"][0] == solos[2] and rank["churn"]["out"][2] == solos[3]


def test_admission_refusals_match_the_reference(weights):
    """A tenant of another dispatch signature, a dense model and a guest
    that does not fit are refused with the reference's messages."""
    from repro.configs import get_smoke_config as j_smoke
    from repro.serve.fleet import TenantFleet as JFleet

    jps, _, tps = weights
    msgs = []
    for Fleet, smoke, ps, kw in ((JFleet, j_smoke, jps, {}),
                                 (TenantFleet, get_smoke_config, tps, {"device": "cpu"})):
        cfg = smoke(ARCH)
        fleet = Fleet((2, 2), max_seq=32, **kw)
        got = []
        with pytest.raises(ValueError, match="MoE") as err:
            fleet.admit_model(smoke("tinyllama-1.1b"), None, guest=(1, 2), slots=2)
        got.append(str(err.value))
        fleet.admit_model(cfg, ps[0], guest=(1, 2), slots=2)
        thin = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, d_ff_expert=64))
        with pytest.raises(ValueError, match="signature") as err:
            fleet.admit_model(thin, ps[1], guest=(1, 2), slots=2)
        got.append(str(err.value))
        fleet.admit_model(cfg, ps[1], guest=(1, 2), slots=2)
        with pytest.raises(ValueError, match="free cabinets") as err:
            fleet.admit_model(cfg, ps[2], guest=(1, 2), slots=2)
        got.append(str(err.value))
        wide = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=6))
        with pytest.raises(ValueError, match="do not shard") as err:
            Fleet((2, 2), max_seq=32, **kw).admit_model(wide, ps[0], guest=(1, 2), slots=2)
        got.append(str(err.value))
        msgs.append(got)
    assert msgs[0] == msgs[1]


def test_fleet_refusals_of_the_port(weights):
    """``collective_report`` names the autotuner's ROADMAP item; the fleet
    runs on the card unless asked for the CPU; a backend is named."""
    _, _, tps = weights
    fleet = TenantFleet((2, 2), max_seq=32, device="cpu")
    fleet.admit_model(get_smoke_config(ARCH), tps[0], guest=(1, 2), slots=2)
    with pytest.raises(NotImplementedError, match="autotuner") as err:
        fleet.collective_report()
    assert "ROADMAP Queue 1 item 3" in str(err.value)
    with pytest.raises(ValueError, match="unknown fleet backend"):
        TenantFleet((2, 2), backend="jax", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TenantFleet((2, 2))


@pytest.mark.parametrize("mux", [False, True], ids=["combined", "time-mux"])
def test_fleet_launcher_matches_the_jax_launcher(mux, tmp_path):
    """``launch.serve --tenants 2`` of both packages on Mixtral smoke: the
    same requests completed, steps, replays, replayed rounds and tokens,
    and the same round counts a boundary. (The JAX launcher's autotuner
    keeps its cache in a temporary file.)"""
    outs = []
    for pkg, extra in (("repro", []), ("repro_torch", ["--device", "cpu"])):
        cmd = [sys.executable, "-m", f"{pkg}.launch.serve", "--arch", ARCH, "--tenants", "2",
               *(["--time-mux"] if mux else []), *extra]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                   REPRO_AUTOTUNE_CACHE=str(tmp_path / "autotune_cache.json"))
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        lines = proc.stdout.splitlines()
        stats = next(line for line in lines if line.startswith("fleet steps"))
        rounds = next(line for line in lines if "time_mux=" in line)
        outs.append((next(line for line in lines if line.startswith("completed")),
                     [part for part in stats.split(", ") if not part.startswith(("wall", "tok"))]
                     + [part for part in stats.split(", ") if part.startswith("tokens:")],
                     rounds[rounds.index("combined="):]))
    assert outs[0] == outs[1]
