"""The collective autotuner (``repro_torch.runtime.autotune``) and the
``auto`` backend (``runtime.backends.auto``), against the JAX package's.

* Key strings are the JAX package's character for character, and the
  candidate sets equal under the port's renames
  ({``pallas_fused``: ``cuda_fused``, ``xla``: ``native``}).
* With the port's seed constants set to the JAX package's values (the
  port's own are H100 figures or say that they are none), the analytic
  prices, priced rounds, combined-site prices, analytic decisions and
  ``moe_site_report`` equal the JAX package's within 1e-9 relative: the
  arithmetic is the same.
* The cache, mode and escape-hatch behaviour of ``tests/test_autotune.py``
  under the port's names (``REPRO_TORCH_AUTOTUNE``,
  ``REPRO_TORCH_AUTOTUNE_CACHE``), plus the device the file names.
* ``AutoBackend(device="cpu")`` bit for bit against the port's
  ``reference`` on integer-valued floats, whatever the tuner picks.

Everything here runs in one process on the CPU, in analytic mode or by
measuring programs of a few KiB. The multi-rank agreement is exercised in
the spawned ranks of ``test_torch_moe_ep.py`` and ``test_torch_fleet.py``.
"""

import json

import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.dist.sharding import ShardRules as JRules
from repro.runtime import autotune as J
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.emulation import disjoint_embeddings
from repro_torch.core.matmul import MatmulGrid
from repro_torch.core.topology import D3
from repro_torch.dist import collectives as dc
from repro_torch.dist.sharding import ShardRules
from repro_torch.runtime import autotune as T
from repro_torch.runtime.backends import get_backend
from repro_torch.runtime.backends.auto import AutoBackend, _chunk_bytes
from repro_torch.runtime.backends.reference import NumpyReferenceBackend

REL = 1e-9
#: the port's seed name -> the JAX package's
SEEDS = {"T_W": "T_W", "BANDWIDTH": "BANDWIDTH", "T_DISPATCH": "T_DISPATCH",
         "T_GROUP": "T_GROUP", "T_KERNEL": "T_KERNEL", "T_NATIVE": "T_XLA",
         "T_TRACE_OP": "T_TRACE_OP", "COMPUTE_RATE": "COMPUTE_RATE"}
#: (layout routers, matmul grid): D3(2,2) with the (2,2) grid, D3(4,4) with (4,4)
SIZES = [(8, (2, 2)), (64, (4, 4))]


def renamed(strategy):
    return T.RENAMED.get(strategy, strategy)


def renamed_keys(prices):
    return {renamed(k): v for k, v in prices.items()}


def close_prices(got, want):
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=REL), k


@pytest.fixture
def jax_seeds(monkeypatch):
    for port, ref in SEEDS.items():
        monkeypatch.setattr(T, port, getattr(J, ref))


@pytest.fixture
def fresh_env(monkeypatch):
    for var in (T.ENV_MODE, T.ENV_CACHE, "REPRO_AUTOTUNE", "REPRO_AUTOTUNE_CACHE"):
        monkeypatch.delenv(var, raising=False)


def tuner(tmp_path, **kw):
    return T.Autotuner(cache_path=tmp_path / "c.json", device="cpu", **kw)


# ----------------------------------------------------------------- keys
@pytest.mark.parametrize("kind", T.KINDS)
@pytest.mark.parametrize("site", T.SITES)
@pytest.mark.parametrize("compute_us,emulated,guests",
                         [(0, False, ""), (512, False, ""), (512, True, ""), (0, True, ""),
                          (0, True, "2xD3(1,2)"), (64, False, "1xD3(1,2)+1xD3(2,2)")])
def test_key_strings_are_the_references(kind, site, compute_us, emulated, guests):
    fields = (kind, 4, 2, 4096, "float32", site, compute_us, emulated, guests)
    assert str(T.TuneKey(*fields)) == str(J.TuneKey(*fields))


@pytest.mark.parametrize("kind", T.KINDS)
@pytest.mark.parametrize("site", T.SITES)
@pytest.mark.parametrize("emulated", [False, True])
def test_candidates_are_the_references_renamed(kind, site, emulated):
    want = tuple(renamed(s) for s in J.candidates(kind, site, emulated=emulated))
    assert T.candidates(kind, site, emulated=emulated) == want
    assert set(want) <= set(T.STRATEGIES)


def test_buckets_and_renames():
    for n in (0, 1, 64, 65, 4096, 5000, 1 << 30):
        assert T.bucket_bytes(n) == J.bucket_bytes(n)
    for n in (0, 1, 2, 3, 300, 25165):
        assert T.bucket_compute_us(n) == J.bucket_compute_us(n)
    assert {renamed(s) for s in J.STRATEGIES} == set(T.STRATEGIES)
    assert T._default_strategy("alltoall", "shard") == renamed(
        J._default_strategy("alltoall", "shard"))
    with pytest.raises(ValueError):
        T.candidates("alltoall", "bogus")


def test_dtype_names_are_numpys_or_torchs():
    assert T.dtype_name(torch.float32) == "float32" == T.dtype_name("float32")
    assert T.dtype_name(np.float32) == "float32"
    assert T.dtype_name(torch.bfloat16) == "bfloat16" == T.dtype_name("bfloat16")


def test_chunk_bytes_site_dependent():
    """A global buffer (n, n, chunk) keys on the per-destination chunk, as
    a shard buffer (n, chunk) does; other kinds on one device's vector,
    all of a shard's, 1/n of a global (n, ...) array's."""
    x_shard = np.zeros((8, 16, 4), np.float32)
    x_glob = torch.zeros((8, 8, 16, 4))
    assert _chunk_bytes(x_shard, "alltoall") == 16 * 4 * 4
    assert _chunk_bytes(x_glob, "alltoall", "global") == 16 * 4 * 4
    assert _chunk_bytes(x_shard, "allreduce") == x_shard.size * 4
    assert _chunk_bytes(x_shard, "allreduce", "global", 8) == 16 * 4 * 4
    from repro.runtime.backends.auto import _chunk_bytes as j_chunk

    assert _chunk_bytes(x_glob, "alltoall", "global") == j_chunk(x_glob.numpy(), "alltoall",
                                                                 "global")


# ------------------------------------------------------- analytic arithmetic
@pytest.mark.parametrize("n,grid", SIZES)
@pytest.mark.parametrize("kind", T.KINDS)
@pytest.mark.parametrize("site", ["host", "global", "shard"])
@pytest.mark.parametrize("compute_us", [0, 5000])
@pytest.mark.parametrize("emulated", [False, True])
def test_analytic_prices_equal_the_references(jax_seeds, n, grid, kind, site, compute_us,
                                              emulated):
    g = grid if kind == "matmul" else None
    cands = J.candidates(kind, site, emulated=emulated)
    want = J.analytic_prices(kind, J.layout_for(n), 4096, cands, g, compute_us)
    got = T.analytic_prices(kind, T.layout_for(n), 4096, tuple(map(renamed, cands)), g,
                            compute_us)
    close_prices(got, renamed_keys(want))
    assert T.priced_rounds(kind, T.layout_for(n), g) == J.priced_rounds(kind, J.layout_for(n), g)


@pytest.mark.parametrize("n,grid", SIZES)
@pytest.mark.parametrize("kind", T.KINDS)
@pytest.mark.parametrize("site", ["host", "global", "shard"])
@pytest.mark.parametrize("compute_us,emulated", [(0, False), (5000, False), (0, True),
                                                 (5000, True)])
def test_analytic_decisions_equal_the_references(jax_seeds, tmp_path, fresh_env, n, grid, kind,
                                                 site, compute_us, emulated):
    g = grid if kind == "matmul" else None
    jd = J.Autotuner(cache_path=tmp_path / "j.json", mode="analytic").decide(
        kind, J.layout_for(n), 4096, site=site, grid=g, emulated=emulated,
        compute_us=compute_us)
    td = tuner(tmp_path, mode="analytic").decide(
        kind, T.layout_for(n), 4096, site=site, grid=g, emulated=emulated,
        compute_us=compute_us)
    assert str(td.key) == str(jd.key)
    assert (td.strategy, td.source, td.rounds, td.hops) == (
        renamed(jd.strategy), jd.source, jd.rounds, jd.hops)
    close_prices(td.analytic_us, renamed_keys(jd.analytic_us))
    assert td.measured_us == {} and not (tmp_path / "c.json").exists()


def _embeddings(pkg, shapes):
    from repro.core.emulation import disjoint_embeddings as j_disjoint
    from repro.core.topology import D3 as JD3

    if pkg == "jax":
        return tuple(j_disjoint(JD3(4, 2), shapes))
    return tuple(disjoint_embeddings(D3(4, 2), shapes))


@pytest.mark.parametrize("shapes", [[(1, 2), (1, 2)], [(1, 2), (2, 2)], [(1, 2)] * 4])
@pytest.mark.parametrize("kind", ["alltoall", "allreduce", "broadcast"])
@pytest.mark.parametrize("nbytes", [4096, 1 << 20])
def test_analytic_combined_prices_equal_the_references(jax_seeds, tmp_path, fresh_env, shapes,
                                                       kind, nbytes):
    want = J.analytic_combined_prices(kind, _embeddings("jax", shapes), nbytes)
    got = T.analytic_combined_prices(kind, _embeddings("port", shapes), nbytes)
    close_prices(got, want)
    assert T.guest_signature(_embeddings("port", shapes)) == J.guest_signature(
        _embeddings("jax", shapes))
    jd = J.Autotuner(cache_path=tmp_path / "j.json", mode="analytic").decide_combined(
        kind, _embeddings("jax", shapes), nbytes)
    td = tuner(tmp_path, mode="analytic").decide_combined(kind, _embeddings("port", shapes),
                                                          nbytes)
    assert (str(td.key), td.strategy, td.source, td.rounds, td.hops) == (
        str(jd.key), jd.strategy, jd.source, jd.rounds, jd.hops)


#: (arch, full config?, rules (data, model), tokens)
REPORTS = {
    "mixtral-smoke-2x4": ("mixtral-8x7b", False, (2, 4), 128),
    "mixtral-smoke-1x8-tp": ("mixtral-8x7b", False, (1, 8), 128),
    "tinyllama-smoke-no-moe": ("tinyllama-1.1b", False, (2, 4), 128),
    "deepseek-v3-full-1x16": ("deepseek-v3-671b", True, (1, 16), 4096),
    "mixtral-8x7b-full-1x16-tp": ("mixtral-8x7b", True, (1, 16), 8192),
}


@pytest.mark.parametrize("case", list(REPORTS))
def test_moe_site_report_equals_the_references(jax_seeds, tmp_path, fresh_env, case):
    arch, full, (n_data, n_model), tokens = REPORTS[case]
    jcfg = j_config(arch) if full else j_smoke(arch)
    cfg = get_config(arch) if full else get_smoke_config(arch)
    want = J.moe_site_report(jcfg, JRules(model_axis_size=n_model, data_axis_size=n_data),
                             n_tokens=tokens,
                             tuner=J.Autotuner(cache_path=tmp_path / "j.json", mode="analytic"))
    got = T.moe_site_report(cfg, ShardRules(model_axis_size=n_model, data_axis_size=n_data),
                            n_tokens=tokens, tuner=tuner(tmp_path, mode="analytic"))
    assert got["status"] == ("ok" if case in ("mixtral-smoke-2x4", "deepseek-v3-full-1x16")
                             else "n/a")
    if want["status"] == "n/a":
        assert got == want
        return
    for field in ("status", "kind", "topology", "key", "source", "rounds", "priced_hops",
                  "moe_collectives", "measured_us"):
        assert got[field] == want[field], field
    assert got["strategy"] == renamed(want["strategy"])
    for k, v in renamed_keys(want["analytic_us"]).items():
        assert got["analytic_us"][k] == pytest.approx(v, abs=0.051)


def test_moe_compute_us_is_the_references():
    for args in ((2, 32, 16, 64, 128), (1, 320, 8, 4096, 14336), (16, 8, 16, 7168, 2048)):
        assert T.moe_compute_us(*args) == J.moe_compute_us(*args)


def test_seeds_are_not_the_tpu_figures():
    """The port's measured seeds are its own (H100 figures), not TPU v5e
    ICI's bandwidth or a Pallas launch."""
    assert T.BANDWIDTH != J.BANDWIDTH and T.T_KERNEL != J.T_KERNEL
    assert T.DEFAULT_CACHE != J.DEFAULT_CACHE
    assert T.DEFAULT_CACHE.parent.name == "build"


# -------------------------------------------------------------- the cache
def test_warm_cache_same_key_same_decision(tmp_path, fresh_env):
    lay = T.layout_for(4)
    d1 = tuner(tmp_path).decide("alltoall", lay, 256, site="host")
    assert d1.source == "measured" and d1.measured_us
    t2 = tuner(tmp_path)
    d2 = t2.decide("alltoall", lay, 256, site="host")
    assert d2.source == "cache" and d2.strategy == d1.strategy
    n = len(t2.decisions)
    assert t2.decide("alltoall", lay, 256, site="host") is d2 and len(t2.decisions) == n


def test_corrupt_cache_falls_back_to_analytic(tmp_path, fresh_env):
    (tmp_path / "c.json").write_text("{this is not json")
    d = tuner(tmp_path, mode="analytic").decide("alltoall", T.layout_for(4), 256, site="host")
    assert d.source == "analytic" and d.strategy in ("loop", "fused")
    (tmp_path / "c.json").write_text("[1, 2]")
    assert tuner(tmp_path)._cache == {}


def test_missing_cache_falls_back_to_analytic(tmp_path, fresh_env):
    t = T.Autotuner(cache_path=tmp_path / "never_written.json", mode="analytic", device="cpu")
    assert t.decide("allreduce", T.layout_for(4), 256, site="host").source == "analytic"


def test_schema_mismatch_ignored(tmp_path, fresh_env):
    (tmp_path / "c.json").write_text(json.dumps(
        {"schema": 999, "device": "cpu", "entries": {"x": {"strategy": "loop"}}}))
    assert tuner(tmp_path, mode="analytic")._cache == {}


def test_file_of_another_device_ignored(tmp_path, fresh_env):
    """A file measured on the card is not read by a tuner that measures on
    the CPU (nor one without a device), and is rewritten by its next
    measurement with its own device."""
    lay = T.layout_for(4)
    key = T.TuneKey("alltoall", lay.topo.K, lay.topo.M, 256, "float32", "host")
    entries = {str(key): {"strategy": "sendrecv", "measured_us": {"sendrecv": 1.0}}}
    for header in ({"device": "NVIDIA H100 80GB HBM3"}, {}):
        (tmp_path / "c.json").write_text(json.dumps(
            {"schema": T.SCHEMA_VERSION, **header, "entries": entries}))
        assert tuner(tmp_path)._cache == {}
    (tmp_path / "c.json").write_text(json.dumps(
        {"schema": T.SCHEMA_VERSION, "device": "cpu", "entries": entries}))
    assert tuner(tmp_path).decide("alltoall", lay, 256, site="host").source == "cache"
    (tmp_path / "c.json").write_text(json.dumps(
        {"schema": T.SCHEMA_VERSION, "device": "NVIDIA H100 80GB HBM3", "entries": entries}))
    d = tuner(tmp_path).decide("alltoall", lay, 256, site="host")
    assert d.source == "measured"
    assert json.loads((tmp_path / "c.json").read_text())["device"] == "cpu"


def test_stale_cache_entry_with_unavailable_strategy_rederived(tmp_path, fresh_env):
    lay = T.layout_for(4)
    key = T.TuneKey("alltoall", lay.topo.K, lay.topo.M, 256, "float32", "host")
    (tmp_path / "c.json").write_text(json.dumps({
        "schema": T.SCHEMA_VERSION, "device": "cpu",
        "entries": {str(key): {"strategy": "native"}},  # not a host candidate
    }))
    d = tuner(tmp_path, mode="analytic").decide("alltoall", lay, 256, site="host")
    assert d.source == "analytic" and d.strategy != "native"
    d = tuner(tmp_path).decide("alltoall", lay, 256, site="host")
    assert d.source == "measured" and d.strategy != "native"


def test_analytic_mode_writes_nothing(tmp_path, fresh_env):
    tuner(tmp_path, mode="analytic").decide("alltoall", T.layout_for(4), 256, site="host")
    assert not (tmp_path / "c.json").exists()


def test_measure_writes_schema_versioned_cache(tmp_path, fresh_env):
    d = tuner(tmp_path).decide("allreduce", T.layout_for(4), 256, site="host")
    assert d.source == "measured"
    raw = json.loads((tmp_path / "c.json").read_text())
    assert raw["schema"] == T.SCHEMA_VERSION and raw["device"] == "cpu"
    assert raw["entries"][str(d.key)]["strategy"] == d.strategy


def test_global_site_measures_only_what_one_process_runs(tmp_path, fresh_env):
    """At the global site one process has no group: fused, cuda_fused
    (here its plain versions) and sendrecv are timed, the group strategies
    are not; a shard site without a group ranks analytically."""
    t = tuner(tmp_path)
    d = t.decide("allreduce", T.layout_for(8), 1024, site="global")
    assert d.source == "measured" and set(d.measured_us) == {"fused", "cuda_fused", "sendrecv"}
    d = t.decide("alltoall", T.layout_for(8), 1024, site="shard")
    assert d.source == "analytic" and d.measured_us == {}
    d = t.decide("matmul", grid=(2, 2), nbytes=64, site="global")
    assert set(d.measured_us) == {"fused", "cuda_fused", "sendrecv"}


# ----------------------------------------------------------- escape hatches
def test_forced_strategy_honored(tmp_path, fresh_env):
    d = tuner(tmp_path, force="fused").decide("alltoall", T.layout_for(4), 256, site="host")
    assert d.strategy == "fused" and d.source == "forced"
    assert not (tmp_path / "c.json").exists()  # forcing never measures


def test_forced_strategy_unavailable_degrades_to_candidate(tmp_path, fresh_env):
    d = tuner(tmp_path, force="cuda_fused").decide("alltoall", T.layout_for(4), 256, site="host")
    assert d.strategy in T.candidates("alltoall", "host")


def test_mode_off_returns_pre_autotuner_defaults(tmp_path, fresh_env):
    t = tuner(tmp_path, mode="off")
    assert t.decide("alltoall", T.layout_for(4), 256, site="shard").strategy == "native"
    assert t.decide("alltoall", T.layout_for(4), 256, site="host").strategy == "loop"


def test_env_escape_hatches(tmp_path, monkeypatch, fresh_env):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "off")
    assert tuner(tmp_path).mode == "off"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "analytic")
    assert tuner(tmp_path).mode == "analytic"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "overlap")
    assert tuner(tmp_path).force == "overlap"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "xla")  # the JAX package's name
    with pytest.raises(ValueError):
        tuner(tmp_path)
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "elsewhere.json"))
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE")
    assert T.Autotuner(device="cpu").cache_path == tmp_path / "elsewhere.json"


def test_the_references_variables_are_not_read(tmp_path, monkeypatch, fresh_env):
    monkeypatch.setenv("REPRO_AUTOTUNE", "off")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax.json"))
    t = T.Autotuner(device="cpu")
    assert t.mode == "measure" and t.cache_path == T.DEFAULT_CACHE


def test_tuner_on_the_card_refuses_without_one(tmp_path, fresh_env):
    if torch.cuda.is_available():
        pytest.skip("this process has a card")
    with pytest.raises(RuntimeError, match="CUDA card"):
        T.Autotuner(cache_path=tmp_path / "c.json")
    with pytest.raises(RuntimeError, match="CUDA card"):
        AutoBackend()


def test_process_wide_tuner_keeps_its_device(tmp_path, fresh_env):
    try:
        T.set_autotuner(None)
        t = T.get_autotuner("cpu")
        assert t.device == torch.device("cpu") and T.get_autotuner() is t
        with pytest.raises(ValueError, match="set_autotuner"):
            T.get_autotuner("cuda")
        mine = tuner(tmp_path)
        T.set_autotuner(mine)
        assert get_backend("auto", device="cpu")._tuner() is mine
    finally:
        T.set_autotuner(None)


# ------------------------------------------------------------ the auto backend
def _collective_inputs(n=8):
    rng = np.random.default_rng(0)
    lay = T.layout_for(n)
    N = MatmulGrid(2, 2).n * 3
    return {
        "alltoall": (dc.alltoall_program(lay), (rng.integers(-8, 9, (n, n, 5)).astype(np.float32),)),
        "allreduce": (dc.allreduce_program(lay), (rng.integers(-8, 9, (n, 16)).astype(np.float32),)),
        "broadcast": (dc.broadcast_program(lay, 1),
                      (rng.integers(-8, 9, (n, 16)).astype(np.float32),)),
        "matmul": (dc.matmul_program(2, 2),
                   tuple(rng.integers(-4, 5, (N, N)).astype(np.float32) for _ in range(2))),
    }


AUTO_MODES = [("analytic", None), ("measure", None)] + [
    (None, s) for s in ("loop", "overlap", "fused", "cuda_fused", "native", "overlap_fused",
                        "sendrecv")]


@pytest.mark.parametrize("mode,force", AUTO_MODES,
                         ids=[m or f"forced-{f}" for m, f in AUTO_MODES])
@pytest.mark.parametrize("kind", T.KINDS)
def test_auto_backend_equals_the_reference(tmp_path, fresh_env, mode, force, kind):
    """Whatever the tuner picks, the result is the reference replay's bits,
    a tensor on the backend's device; in one process a strategy that needs
    a group degrades to the fused replay."""
    t = tuner(tmp_path, mode=mode, force=force)
    be = get_backend("auto", device="cpu", tuner=t)
    prog, args = _collective_inputs()[kind]
    got = getattr(be, f"run_{kind}")(*args, prog)
    want = getattr(NumpyReferenceBackend(), f"run_{kind}")(*args, prog)
    assert isinstance(got, torch.Tensor) and got.device == torch.device("cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy().dtype == want.dtype
    dec = t.decisions[-1]
    ran = AutoBackend._global_strategy(dec)
    assert ran in ("fused", "cuda_fused", "sendrecv")
    if dec.strategy in T.GROUP_STRATEGIES:
        assert ran == "fused"
    if force is not None and force in T.candidates(kind, "global"):
        assert dec.strategy == force


def test_auto_backend_takes_tensors_and_optimized_programs(tmp_path, fresh_env):
    be = AutoBackend(tuner=tuner(tmp_path), device="cpu")
    prog, (x,) = _collective_inputs()["allreduce"]
    want = NumpyReferenceBackend().run_allreduce(x, prog)
    for p in (prog, dc.allreduce_program(T.layout_for(8), optimized=True)):
        np.testing.assert_array_equal(be.run_allreduce(torch.from_numpy(x), p).numpy(), want)


def test_emulated_program_never_runs_native(tmp_path, fresh_env):
    """Guest-on-host programs key ``|emu`` and exclude ``native``: a native
    decision at the same shapes is never replayed there, and forcing
    ``native`` falls to a candidate that replays the guest exactly."""
    from repro_torch.dist.mesh import DeviceLayout

    host = T.layout_for(8)
    guest = DeviceLayout(D3(1, 2))
    emb = guest.embed_onto(host)
    prog = dc.alltoall_program(guest, emb)
    t = tuner(tmp_path, force="native")
    d_native = t.decide("alltoall", host, 256, site="shard")
    d_emu = t.decide("alltoall", host, 256, site="shard", emulated=True)
    assert d_native.strategy == "native" and d_emu.strategy != "native"
    assert str(d_emu.key).endswith("|emu") and "native" not in d_emu.analytic_us
    x = np.random.default_rng(1).integers(-8, 9, (8, 8, 3)).astype(np.float32)
    got = AutoBackend(tuner=t, device="cpu").run_alltoall(x, prog)
    np.testing.assert_array_equal(got.numpy(), NumpyReferenceBackend().run_alltoall(x, prog))
    assert t.decisions[-1].key.emulated and t.decisions[-1].strategy != "native"


# --------------------------------------------------------- combined guest site
def test_decide_combined_key_and_measured_win(tmp_path, fresh_env):
    embs = _embeddings("port", [(1, 2), (1, 2)])
    t = tuner(tmp_path)
    dec = t.decide_combined("alltoall", embs, nbytes=4096)
    assert str(dec.key).endswith("|combined|emu|g2xD3(1,2)")
    assert str(dec.key) == str(J.Autotuner(cache_path=tmp_path / "j.json", mode="analytic")
                               .decide_combined("alltoall", _embeddings("jax", [(1, 2), (1, 2)]),
                                                nbytes=4096).key)
    assert dec.source == "measured" and set(dec.measured_us) == {"combined", "time_mux"}
    assert dec.strategy == "combined"
    assert dec.analytic_us["combined"] < dec.analytic_us["time_mux"]
    assert t.decide_combined("alltoall", embs[::-1], nbytes=4096) is dec
    dec2 = tuner(tmp_path).decide_combined("alltoall", embs, nbytes=4096)
    assert dec2.source == "cache" and dec2.strategy == dec.strategy


def test_decide_combined_modes_and_candidates(tmp_path, fresh_env):
    embs = _embeddings("port", [(1, 2), (1, 2)])
    assert T.candidates("alltoall", "combined") == ("combined", "time_mux")
    d = T.Autotuner(cache_path=tmp_path / "a.json", mode="analytic",
                    device="cpu").decide_combined("alltoall", embs, nbytes=1 << 20)
    assert d.source == "analytic" and d.strategy == "combined"
    off = T.Autotuner(cache_path=tmp_path / "b.json", mode="off", device="cpu")
    assert off.decide_combined("alltoall", embs).strategy == "time_mux"
    forced = T.Autotuner(cache_path=tmp_path / "d.json", force="time_mux", device="cpu")
    assert forced.decide_combined("alltoall", embs).source == "forced"
    with pytest.raises(ValueError, match="at least one"):
        forced.decide_combined("alltoall", ())
    assert "|g" not in str(T.TuneKey("alltoall", 4, 2, 4096, "float32", "shard"))
    # broadcast has no device-free replay to time: analytic even when measuring
    d = tuner(tmp_path).decide_combined("broadcast", embs, nbytes=4096)
    assert d.source == "analytic"
