"""The port's serving engine against the JAX package's, on the CPU.

Both engines get the same parameters (the JAX package's ``init_params``,
carried across by ``params_from_jax``) and the same requests, made by
numpy from a seed, and are driven by the same script of admits and steps.
Greedy decoding turns float32 logits into token ids, which must be equal,
as must ``steps_run``, ``tokens_out`` and which requests are done when:
the continuous-batching bookkeeping is the JAX engine's line for line.
"""

import numpy as np
import pytest
import torch
import jax

from repro.configs import get_smoke_config as j_smoke
from repro.models import model as JM
from repro.serve.engine import Engine as JEngine, Request as JRequest

from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as t_serve
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.engine import Engine as TEngine, Request as TRequest


def engine_pairs(arch):
    """A factory of (JAX engine, port engine) pairs on one set of weights."""
    jcfg, cfg = j_smoke(arch), get_smoke_config(arch)
    jp = JM.init_params(jax.random.key(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")

    def make(slots, max_seq):
        return (JEngine(jcfg, jp, batch_slots=slots, max_seq=max_seq),
                TEngine(cfg, tp, batch_slots=slots, max_seq=max_seq, device="cpu"))
    return make


@pytest.fixture(scope="module")
def engines():
    return engine_pairs("tinyllama-1.1b")


def prompts(seed, n, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=rng.integers(3, 9)).astype(np.int32) for _ in range(n)]


def serve_loop(eng, Request, prompt_list, max_new):
    """The launcher's loop: admit while slots are free, step, collect."""
    pending = [Request(rid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompt_list)]
    submitted, done = list(pending), []
    while pending or eng.slot_req:
        while pending and eng.free_slots:
            eng.admit(pending.pop(0))
        eng.step()
        done.extend(r for r in submitted if r.done and r not in done)
    return [(r.rid, r.out) for r in done]


def same_state(jeng, teng):
    assert (jeng.steps_run, jeng.tokens_out) == (teng.steps_run, teng.tokens_out)
    np.testing.assert_array_equal(jeng.positions, teng.positions)
    assert sorted(jeng.slot_req) == sorted(teng.slot_req)


@pytest.mark.parametrize("slots,n,max_new", [(4, 6, 12), (2, 5, 4), (1, 3, 2)])
def test_launcher_loop_gives_the_same_tokens(engines, slots, n, max_new):
    jeng, teng = engines(slots, 128)
    ps = prompts(slots + n, n)
    assert serve_loop(teng, TRequest, ps, max_new) == serve_loop(jeng, JRequest, ps, max_new)
    same_state(jeng, teng)


def test_coadvance_finish_mid_prefill(engines):
    """A decoding request spends its budget while a long prompt prefills."""
    outs = []
    for eng, Request in zip(engines(2, 64), (JRequest, TRequest)):
        a = Request(rid=0, prompt=np.asarray([3, 7], np.int32), max_new_tokens=3)
        eng.admit(a)
        eng.step()
        b = Request(rid=1, prompt=np.asarray([9, 8, 7, 6, 5, 4], np.int32), max_new_tokens=2)
        eng.admit(b)
        assert a.done and b.out == []
        eng.run_to_completion()
        outs.append((a.out, b.out, eng.steps_run, eng.tokens_out))
    assert outs[0] == outs[1]


def test_slot_freed_and_reused_in_one_step_and_max_seq_cut(engines):
    outs = []
    for eng, Request in zip(engines(1, 12), (JRequest, TRequest)):
        r1 = Request(rid=0, prompt=np.asarray([4, 13], np.int32), max_new_tokens=1)
        eng.admit(r1)
        eng.step()
        assert r1.done and eng.free_slots == [0]
        r2 = Request(rid=1, prompt=np.asarray([5, 9, 42], np.int32), max_new_tokens=100)
        assert eng.admit(r2)
        eng.run_to_completion()
        assert r2.done and 0 < len(r2.out) < 100  # cut at max_seq - 1
        outs.append((r1.out, r2.out, eng.steps_run, eng.tokens_out))
    assert outs[0] == outs[1]


def test_launcher_runs_on_the_cpu(capsys):
    steps = t_serve.main(["--device", "cpu", "--requests", "6", "--max-new", "12"])
    out = capsys.readouterr().out
    assert "completed 6/6 requests" in out and steps > 0
    assert out.count(", 12)") == 6  # every request got its 12 tokens


def test_launcher_matches_the_jax_launcher_step_count(capsys):
    """Same seed, same prompts: the two launchers run the same number of
    engine steps (their weights differ: each draws its own)."""
    from repro.launch import serve as j_serve
    argv = ["--requests", "4", "--max-new", "5", "--seed", "3"]
    assert t_serve.main(argv + ["--device", "cpu"]) == j_serve.main(argv)


def test_mixtral_engines_give_the_same_tokens():
    """The MoE model behind both engines (Mixtral smoke, its sparse
    dispatch on every decode step), driven by the launcher's loop with its
    smoke defaults: 4 slots, 6 requests, 12 new tokens."""
    jeng, teng = engine_pairs("mixtral-8x7b")(4, 128)
    ps = prompts(11, 6)
    assert serve_loop(teng, TRequest, ps, 12) == serve_loop(jeng, JRequest, ps, 12)
    same_state(jeng, teng)


def test_overlong_prompt_is_refused_and_changes_nothing(engines):
    """A prompt of max_seq + 1 tokens raises ValueError before the engine
    seats it: the slots, positions, pending tokens, cache and counters
    stay as they were, and the engine goes on serving."""
    _, eng = engines(2, 8)
    eng.admit(TRequest(rid=0, prompt=np.asarray([4, 13, 7], np.int32), max_new_tokens=3))
    eng.step()
    before = (dict(eng.slot_req), eng.positions.copy(), eng.pending_tok.copy(),
              [{k: v.clone() for k, v in c.items()} for c in eng.cache["stack"]],
              eng.steps_run, eng.tokens_out)
    long = TRequest(rid=1, prompt=np.arange(1, 10, dtype=np.int32), max_new_tokens=2)
    with pytest.raises(ValueError, match="max_seq"):
        eng.admit(long)
    assert eng.slot_req == before[0] and long.out == [] and not long.done
    np.testing.assert_array_equal(eng.positions, before[1])
    np.testing.assert_array_equal(eng.pending_tok, before[2])
    for got, want in zip(eng.cache["stack"], before[3]):
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert (eng.steps_run, eng.tokens_out) == before[4:]
    eng.run_to_completion()
    assert eng.slot_req == {} and len(before[0][0].out) == 3


def test_prompt_of_exactly_max_seq_matches_the_jax_engine(engines):
    """A prompt that fills the cache to its last position is served, and
    gives the JAX engine's tokens and state."""
    outs = []
    for eng, Request in zip(engines(2, 8), (JRequest, TRequest)):
        a = Request(rid=0, prompt=np.asarray([5, 9, 42], np.int32), max_new_tokens=4)
        b = Request(rid=1, prompt=np.arange(3, 11, dtype=np.int32), max_new_tokens=4)
        assert eng.admit(a) and eng.admit(b)
        eng.run_to_completion()
        assert a.done and b.done and len(b.out) == 1  # cut at max_seq - 1
        outs.append((a.out, b.out, eng.steps_run, eng.tokens_out, eng.positions.tolist()))
    assert outs[0] == outs[1]
