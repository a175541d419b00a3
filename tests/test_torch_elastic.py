"""The port's elastic trainer and training launcher, on the CPU (TinyLlama
smoke, float32).

The cascade drill of ``tests/test_elastic.py``: host D3(2, 2), devices 1
and 4 killed at steps 3 and 7, the run shrinking to D3(1, 2) and then
D3(2, 1) with zero derivations, every rewind's parameters carried by the
rewritten §5 broadcast, the losses within 1e-4 of an uninterrupted run's
and of the JAX package's ``ElasticTrainer`` on the same drill (the port's
trainer starts from the JAX package's initial state, carried across by
``models.convert``). Then the launcher: the two-phase restart of
``examples/train_tinyllama.py`` (train to half, ``--restore``, finish)
against an uninterrupted run, and ``--elastic`` from the command line.
"""

import re

import numpy as np
import pytest
import jax

from repro.configs import get_smoke_config as j_smoke
from repro.core.topology import D3 as JD3
from repro.train.elastic import ElasticTrainer as JElasticTrainer
from repro.train.elastic import FaultInjector as JFaultInjector
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.train_step import TrainSettings as JTrainSettings
from repro.train.train_step import init_train_state as j_init_train_state

from repro_torch.configs import get_smoke_config
from repro_torch.core.topology import D3
from repro_torch.launch import train as launcher
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.train import elastic
from repro_torch.train.elastic import ElasticTrainer, FaultInjector, max_loss_divergence
from repro_torch.train.fault_tolerance import derivation_count
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import TrainSettings
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

ARCH = "tinyllama-1.1b"
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)
DRILL = dict(batch=4, seq=16, seed=0, ckpt_every=2)
FAILURES = {3: [1], 7: [4]}


@pytest.fixture(scope="module")
def cascade_runs(tmp_path_factory):
    """The port's uninterrupted and twice-shrinking runs and the JAX
    package's twice-shrinking run, all from the JAX package's seed-0 state."""
    cfg, jcfg = get_smoke_config(ARCH), j_smoke(ARCH)

    def jax_init(seed, cfg, opt_cfg, settings, device):
        jp, jo = j_init_train_state(jax.random.key(seed), jcfg, JOptConfig(**OPT),
                                    JTrainSettings(use_kernel=False, remat=False))
        return (params_from_jax(jax.tree.map(np.asarray, jp), cfg, device=device),
                opt_state_from_jax(jax.tree.map(np.asarray, jo), cfg, device=device))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(elastic, "init_train_state", jax_init)
        runs = {}
        for name, injector in (("base", None), ("elastic", FaultInjector(FAILURES))):
            trainer = ElasticTrainer(
                cfg, OptConfig(**OPT), TrainSettings(use_kernel=False, remat=False),
                ckpt_dir=tmp_path_factory.mktemp(name), host=D3(2, 2), injector=injector,
                device="cpu", **DRILL)
            runs[name] = (trainer, trainer.run(10))
    jtrainer = JElasticTrainer(
        jcfg, JOptConfig(**OPT), JTrainSettings(use_kernel=False, remat=False),
        ckpt_dir=tmp_path_factory.mktemp("jax"), host=JD3(2, 2),
        injector=JFaultInjector(FAILURES), **DRILL)
    runs["jax"] = (jtrainer, jtrainer.run(10))
    return runs


def test_cascade_survives_and_shrinks_twice(cascade_runs):
    el, losses = cascade_runs["elastic"]
    assert len(losses) == 10
    assert [e.shape for e in el.events] == [(1, 2), (2, 1)]
    assert [e.absorbed for e in el.events] == [False, False]
    assert len(el.events[1].survivors) < len(el.events[0].survivors)
    dead_so_far: set = set()
    for e in el.events:
        dead_so_far |= set(e.failed)
        assert not set(e.survivors) & dead_so_far
        assert e.derivations == 0          # rewrite-only, asserted per event
        assert e.broadcast_rounds >= 1     # shards moved via the §5 program
        assert e.bytes_redistributed == 4 * sum(
            p.numel() for _, p in elastic.flatten(el._params))
        assert e.resumed_from <= e.step
    jel, _ = cascade_runs["jax"]
    for ours, theirs in zip(el.events, jel.events):
        assert (ours.step, ours.failed, ours.shape, ours.survivors, ours.resumed_from,
                ours.broadcast_rounds, ours.bytes_redistributed) == (
            theirs.step, theirs.failed, theirs.shape, theirs.survivors, theirs.resumed_from,
            theirs.broadcast_rounds, theirs.bytes_redistributed)


def test_cascade_loss_continuity(cascade_runs):
    """Post-failover losses equal the uninterrupted run's at equal data
    state, and the JAX package's elastic run's."""
    _, base = cascade_runs["base"]
    _, ours = cascade_runs["elastic"]
    _, theirs = cascade_runs["jax"]
    assert set(base) == set(ours) == set(theirs)
    assert max_loss_divergence(base, ours) < 1e-4
    assert max_loss_divergence(ours, theirs) < 1e-4
    assert ours[9] < ours[0]


def test_cascade_reuses_memoized_library(cascade_runs):
    el, _ = cascade_runs["elastic"]
    d0 = derivation_count()
    p1 = el.cluster.plan_recovery()
    p2 = el.cluster.plan_recovery()
    assert derivation_count() == d0
    assert set(el.cluster.library) >= {(2, 2), (1, 2), (2, 1), (1, 1)}
    for kind in p1.programs:
        assert p1.programs[kind] is p2.programs[kind]


def test_ravel_round_trips_bf16():
    """The payload is the float32 ravel of the parameters; bf16 leaves come
    back with their bits."""
    import torch

    params = {"a": torch.randn(3, 4).to(torch.bfloat16), "s": [{"b": torch.randn(5)}]}
    vec, unravel = elastic.ravel(params)
    assert vec.dtype == torch.float32 and vec.numel() == 17
    back = unravel(vec.clone())
    assert back["a"].dtype == torch.bfloat16 and torch.equal(back["a"], params["a"])
    assert torch.equal(back["s"][0]["b"], params["s"][0]["b"])


# ------------------------------------------------------------------ launcher
STEP_LINE = re.compile(r"^step +(\d+) loss (\S+) gnorm (\S+) ")


def run_launcher(capsys, *argv):
    final = launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "4",
                           "--seq", "32", *argv])
    out = capsys.readouterr().out
    return final, out, {int(m[1]): (m[2], m[3]) for m in map(STEP_LINE.match, out.splitlines())
                        if m}


def test_launcher_two_phase_restart_matches_an_uninterrupted_run(tmp_path, capsys):
    """Phase 1 trains to half and checkpoints; phase 2 restores (params,
    optimizer state, data state) and finishes. Steps 0-9 sit in the
    10-step warmup, where the schedule does not depend on --steps, so the
    resumed run is the uninterrupted run's, line for line."""
    full_loss, _, full = run_launcher(capsys, "--steps", "20", "--ckpt-dir",
                                      str(tmp_path / "full"))
    _, _, first = run_launcher(capsys, "--steps", "10", "--ckpt-dir", str(tmp_path / "two"),
                               "--ckpt-every", "5")
    final, out, second = run_launcher(capsys, "--steps", "20", "--ckpt-dir",
                                      str(tmp_path / "two"), "--ckpt-every", "50", "--restore")
    assert "restored step=10" in out
    assert sorted(first) == list(range(10)) and sorted(second) == list(range(10, 20))
    assert {**first, **second} == full
    assert abs(final - full_loss) < 1e-4
    assert float(full[19][0]) < float(full[0][0])


def test_launcher_elastic_mode(tmp_path, capsys):
    final, out, _ = run_launcher(capsys, "--steps", "10", "--ckpt-dir", str(tmp_path),
                                 "--ckpt-every", "2", "--elastic", "--host", "2", "2",
                                 "--inject-failures", "3:1,7:4")
    assert "fault schedule: {3: (1,), 7: (4,)}" in out
    events = [line for line in out.splitlines() if line.startswith("failover")]
    assert len(events) == 2 and all("0 derivations" in e and "rewound" in e for e in events)
    assert "D3(1, 2)" in events[0] and "D3(2, 1)" in events[1]
    assert f"10 steps, 2 failovers, final loss {final:.4f}" in out


def test_launcher_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA card"):
        launcher.main(["--smoke", "--steps", "1"])
