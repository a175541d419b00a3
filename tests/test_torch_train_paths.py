"""The port's microbatch, gradient-compression and straggler paths
against the JAX package's, on the CPU (TinyLlama and Jamba smoke,
float32), from the same state and batches as ``test_torch_train_loop.py``
(whose helpers these are): each step's loss, grad_norm and lr within
1e-4 relative, each microbatch's gradients within 1e-4 of the leaf's
norm. The JAX launcher's ``--compress-grads`` raises (its
``decompress_tree`` fails on any tree holding a tuple, as a model's
``stack`` is), so the compressed step is held against the reference's
pieces composed as its ``make_train_step`` composes them.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as j_smoke
from repro.models import model as JM
from repro.train import compression as JC
from repro.train import optimizer as JO
from repro.train import train_step as JTS
from repro.train.fault_tolerance import renormalized_scale

from repro_torch.configs import get_smoke_config
from repro_torch.models.convert import params_from_jax
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS
from test_torch_models import batch_for
from test_torch_train import jax_decompress, one_torch_thread  # noqa: F401 (autouse)
from test_torch_train_loop import OPT, STEP_TOL, assert_metrics_close, run_steps, start
from test_torch_train_step import assert_grads_close

PATH_ARCHS = ["tinyllama-1.1b", "jamba-1.5-large-398b"]


@pytest.mark.parametrize("arch", PATH_ARCHS)
def test_microbatches_match(arch):
    """Four microbatches: float32 gradients summed and averaged, the loss
    the mean over the microbatches."""
    cfg, jcfg = get_smoke_config(arch), j_smoke(arch)
    kw = dict(use_kernel=False, remat=True, microbatches=4)
    run_steps(arch, 2, 4, 16,
              jax.jit(JTS.make_train_step(jcfg, JO.OptConfig(**OPT), JTS.TrainSettings(**kw))),
              TS.make_train_step(cfg, O.OptConfig(**OPT), TS.TrainSettings(**kw)), remat=True)


def test_microbatches_split_mrope_positions_on_axis_1():
    cfg = get_smoke_config("qwen2-vl-7b")
    jb, tb = batch_for(cfg, 4, 8, 0)
    jmbs = JTS.split_microbatches(jb, 2)
    for got, want in zip(TS.split_microbatches(tb, 2), jmbs):
        assert got.keys() == want.keys()
        for key in got:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert tuple(TS.split_microbatches(tb, 2)[0]["mrope_positions"].shape) == (3, 2, 8)


def jax_compressed_step(jcfg, opt_cfg):
    """The reference's ``make_train_step`` with ``compress_grads``, its
    ``decompress_tree`` walked per path (``test_torch_train.jax_decompress``)."""

    @jax.jit
    def grads_of(p, b):
        return jax.value_and_grad(
            lambda p, b: JM.loss_fn(p, b, jcfg, use_kernel=False, remat=True),
            has_aux=True)(p, b)

    compress = jax.jit(JC.compress_tree)
    apply_updates = jax.jit(JO.apply_updates, static_argnums=3)

    def step(params, opt_state, batch):
        (loss, metrics), grads = grads_of(params, batch)
        codes, new_err = compress(grads, opt_state["err"])
        grads = jax.tree.map(jnp.asarray, jax_decompress(codes, grads))
        inner = {k: v for k, v in opt_state.items() if k != "err"}
        params, inner, om = apply_updates(params, grads, inner, opt_cfg)
        return params, dict(inner, err=new_err), dict(metrics, **om, loss=loss)

    return step


@pytest.mark.parametrize("arch", PATH_ARCHS)
def test_compressed_gradients_match(arch):
    cfg, jcfg = get_smoke_config(arch), j_smoke(arch)
    kw = dict(use_kernel=False, remat=True, compress_grads=True)
    to, jo = run_steps(arch, 2, 2, 16, jax_compressed_step(jcfg, JO.OptConfig(**OPT)),
                       TS.make_train_step(cfg, O.OptConfig(**OPT), TS.TrainSettings(**kw)),
                       compress_grads=True)
    want = dict(O.flatten(params_from_jax(jax.tree.map(np.asarray, jo["err"]), cfg,
                                          device="cpu")))
    for path, got in O.flatten(to["err"]):
        # the residual is under half a quantum a value; a value at a rounding
        # edge may take the other code, so compare the residuals' norms
        np.testing.assert_allclose(float(got.norm()), float(want[path].norm()), rtol=1e-2,
                                   err_msg=str(path))


@pytest.mark.parametrize("arch", PATH_ARCHS)
def test_straggler_path_matches(arch):
    """``make_microbatch_grads`` per microbatch and ``make_apply_step`` on
    the kept ones (microbatch 2 of 4 dropped, the rest renormalized), as
    the launcher's ``--straggler-drop`` composes them."""
    cfg, jcfg, (jp, jo), (tp, to) = start(arch, remat=True)
    kw = dict(use_kernel=False, remat=True, microbatches=4)
    jmb = jax.jit(JTS.make_microbatch_grads(jcfg, JTS.TrainSettings(**kw)))
    japply = jax.jit(JTS.make_apply_step(jcfg, JO.OptConfig(**OPT), JTS.TrainSettings(**kw)))
    tmb = TS.make_microbatch_grads(cfg, TS.TrainSettings(**kw))
    tapply = TS.make_apply_step(cfg, O.OptConfig(**OPT), TS.TrainSettings(**kw))
    keep = [True, True, False, True]
    scale = renormalized_scale(sum(keep), len(keep)) / len(keep)
    for s in range(2):
        jb, tb = batch_for(cfg, 4, 16, 20 + s)
        jres = [jmb(jp, mb) for mb, k in zip(JTS.split_microbatches(jb, 4), keep) if k]
        tres = [tmb(tp, mb) for mb, k in zip(TS.split_microbatches(tb, 4), keep) if k]
        for (tl, _, tg), (jl, _, jg) in zip(tres, jres):
            assert abs(float(tl) - float(jl)) <= STEP_TOL * abs(float(jl))
            assert_grads_close(tg, params_from_jax(jax.tree.map(np.asarray, jg), cfg,
                                                   device="cpu"), STEP_TOL)
        jg = jax.tree.map(lambda *gs: sum(gs) * scale, *(g for _, _, g in jres))
        tg = O.unflatten(tp, [sum(gs) * scale for gs in zip(
            *[[x for _, x in O.flatten(g)] for _, _, g in tres])])
        jp, jo, jm = japply(jp, jo, jg, sum(l for l, _, _ in jres) * scale, jres[-1][1])
        tp, to, tm = tapply(tp, to, tg, sum(l for l, _, _ in tres) * scale, tres[-1][1])
        assert_metrics_close(tm, jm, (arch, s))
