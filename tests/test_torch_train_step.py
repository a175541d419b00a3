"""The port's gradients against ``jax.grad``, on every arch of the registry
(smoke configs, float32, the CPU).

Parameters come from the JAX package's ``init_params`` and are carried
across by ``models.convert.params_from_jax`` (the gradients too, so both
sides are compared in the port's per-layer layout); inputs are made by
numpy from a seed (``test_torch_models.batch_for``: Qwen2-VL gets
``mrope_positions`` (3, B, S), which neither package's ``SyntheticLM``
makes). Each leaf's gradient agrees within ``MODEL_TOL`` relative to the
leaf's norm: ||Δ|| <= 1e-4·||g||. A leaf the loss does not reach (the
``embed`` table of the archs that read embeddings) gets zeros, as under
``jax.grad``. Remat (``torch.utils.checkpoint`` over each group of the
stack and each prefix layer) changes no bit on the CPU.
"""

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch
import jax

from repro.configs import get_smoke_config as j_smoke
from repro.models import model as JM

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models.convert import params_from_jax
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS
from test_torch_models import MODEL_TOL, batch_for
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)


def setup(arch, seed=0):
    cfg = get_smoke_config(arch)
    jp = JM.init_params(jax.random.key(seed), j_smoke(arch))
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def port_grads(params, batch, cfg, remat):
    settings = TS.TrainSettings(use_kernel=False, remat=remat)
    return TS.make_microbatch_grads(cfg, settings)(params, batch)


def assert_grads_close(got, want, tol):
    want = dict(O.flatten(want))
    for path, g in O.flatten(got):
        w = want[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        err = float((g - w).norm())
        assert err <= tol * float(w.norm()) + 1e-12, (path, err, float(w.norm()))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_gradients_match_jax_grad(arch):
    cfg, jp, tp = setup(arch)
    jb, tb = batch_for(cfg, 2, 16, 1)
    jcfg = j_smoke(arch)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, b, jcfg, use_kernel=False, remat=True), has_aux=True))(jp, jb)
    loss, metrics, grads = port_grads(tp, tb, cfg, remat=True)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=MODEL_TOL)
    assert float(metrics["loss"]) == float(loss)
    assert_grads_close(grads, params_from_jax(jax.tree.map(np.asarray, jg), cfg, device="cpu"),
                       MODEL_TOL)
    if cfg.embeds_input:  # the table the loss does not read: zeros, as jax.grad gives
        assert not grads["embed"]["table"].any()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_changes_no_bit(arch):
    """remat=True recomputes each group in the backward: the loss and
    every gradient equal remat=False's."""
    cfg, _, tp = setup(arch, seed=1)
    _, tb = batch_for(cfg, 2, 16, 2)
    with_remat, without = (port_grads(tp, tb, cfg, remat) for remat in (True, False))
    assert float(with_remat[0]) == float(without[0])
    for (path, a), (_, b) in zip(O.flatten(with_remat[2]), O.flatten(without[2])):
        assert torch.equal(a, b), path


def test_chip_smoke_counts_no_profiler_range_as_a_kernel():
    """``stack.group`` (a remat'd group) and every other profiler range the
    port opens has a span on the card that is not a kernel:
    ``chip_smoke.py``'s device profile leaves each one out by name."""
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    opened = {name for f in (root / "src" / "repro_torch").rglob("*.py")
              for name in re.findall(r'record_function\("([^"]+)"\)', f.read_text())}
    assert "stack.group" in opened
    assert opened <= set(smoke.PROFILER_RANGES), opened - set(smoke.PROFILER_RANGES)
