"""The port's train step against the JAX package's, on the CPU (smoke
configs, float32): five steps of ``make_train_step`` on every arch
(``test_torch_train_paths.py`` holds the microbatch, compression and
straggler paths).

Both sides start from the same parameters and optimizer state (the JAX
package's ``init_train_state``, carried across by
``models.convert.params_from_jax`` and ``opt_state_from_jax``) and take
the same numpy batches. Each step's loss, grad_norm and lr agree within
1e-4 relative. Parameters are not compared elementwise after a step: at
step 1 Adam moves every parameter by about lr·sign(g), so a gradient of
~1e-10 whose sign differs by rounding moves by 2·lr; the gradients and
the optimizer are held on identical inputs in ``test_torch_train_step.py``
and ``test_torch_train.py``.
"""

import numpy as np
import pytest
import jax

from repro.configs import get_smoke_config as j_smoke
from repro.train import optimizer as JO
from repro.train import train_step as JTS

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS
from test_torch_models import batch_for
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

STEP_TOL = 1e-4
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)


def start(arch, **settings):
    """(port cfg, JAX cfg, JAX state, port state) from the JAX package's
    ``init_train_state`` with seed 0."""
    cfg, jcfg = get_smoke_config(arch), j_smoke(arch)
    jp, jo = JTS.init_train_state(jax.random.key(0), jcfg, JO.OptConfig(**OPT),
                                  JTS.TrainSettings(use_kernel=False, **settings))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    to = opt_state_from_jax(jax.tree.map(np.asarray, jo), cfg, device="cpu")
    return cfg, jcfg, (jp, jo), (tp, to)


def assert_metrics_close(got, want, what):
    for key in ("loss", "grad_norm", "lr"):
        g, w = float(got[key]), float(want[key])
        assert abs(g - w) <= STEP_TOL * abs(w), (what, key, g, w)


def run_steps(arch, steps, B, S, jax_step, port_step, **settings):
    cfg, _, (jp, jo), (tp, to) = start(arch, **settings)
    for s in range(steps):
        jb, tb = batch_for(cfg, B, S, 10 + s)
        jp, jo, jm = jax_step(jp, jo, jb)
        tp, to, tm = port_step(tp, to, tb)
        assert_metrics_close(tm, jm, (arch, s))
        assert int(to["step"]) == int(jo["step"]) == s + 1
    return to, jo


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_five_steps_match(arch):
    cfg, jcfg = get_smoke_config(arch), j_smoke(arch)
    jst = JTS.TrainSettings(use_kernel=False, remat=True)
    run_steps(arch, 5, 2, 16,
              jax.jit(JTS.make_train_step(jcfg, JO.OptConfig(**OPT), jst)),
              TS.make_train_step(cfg, O.OptConfig(**OPT),
                                 TS.TrainSettings(use_kernel=False, remat=True)), remat=True)
