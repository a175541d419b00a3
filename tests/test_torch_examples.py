"""The port's four examples (``examples/torch/``) on the CPU, against the
JAX package's (``examples/``).

Each example runs as a subprocess with ``src`` on the path and
``--device cpu`` where it touches a device, beside the JAX example where
the two print the same quantities (``JAX_PLATFORMS=cpu``); all of them
start at once, on one intra-op thread each. ``quickstart`` prints the JAX
example's lines; ``elastic_failover`` prints them up to the backends, and
one bit-exact line for each backend the port registers; ``serve_moe``,
run in this process on the JAX example's weights (``init_params(
jax.random.key(0), cfg)``, carried across by ``models.convert
.params_from_jax``), gives the JAX example's tokens request by request,
and standalone ends every request with its 8 tokens; ``train_tinyllama``
resumes to the final loss of one straight run of as many steps within
``RESTART_TOL`` (it prints the loss to 4 decimals).
"""

import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.launch import train as launcher
from repro_torch.runtime.backends import available_backends
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

TESTS = pathlib.Path(__file__).resolve().parent
REPO = TESTS.parent
EXAMPLES = REPO / "examples"
RESTART_TOL = 1e-4
TRAIN_STEPS = 4
#: (name, the command's arguments after the interpreter)
RUNS = {
    "jax_quickstart": [str(EXAMPLES / "quickstart.py")],
    "quickstart": [str(EXAMPLES / "torch" / "quickstart.py")],
    "jax_elastic_failover": [str(EXAMPLES / "elastic_failover.py")],
    "elastic_failover": [str(EXAMPLES / "torch" / "elastic_failover.py"), "--device", "cpu"],
    "jax_serve_moe": [str(EXAMPLES / "serve_moe.py")],
    "serve_moe": [str(EXAMPLES / "torch" / "serve_moe.py"), "--device", "cpu"],
    "train_tinyllama": [str(EXAMPLES / "torch" / "train_tinyllama.py"), "--device", "cpu",
                        "--steps", str(TRAIN_STEPS)],
}
SERVED = re.compile(r"rid=(\d+) prompt=.* -> generated (\[[\d, ]*\])$")


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """{name: stdout} of every run of ``RUNS``, each required to exit 0;
    the training example writes its checkpoints under a temporary
    directory (``ckpt_dir``)."""
    root = tmp_path_factory.mktemp("examples")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    extra = {"train_tinyllama": ["--ckpt-dir", str(root / "ckpt")]}
    procs = {name: subprocess.Popen([sys.executable, *args, *extra.get(name, [])], env=env,
                                    cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
             for name, args in RUNS.items()}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, (name, stderr[-4000:])
        out[name] = stdout
    out["ckpt_dir"] = root / "ckpt"
    return out


def _lines(text):
    return text.rstrip("\n").split("\n")


def test_quickstart_prints_the_jax_examples_lines(outputs):
    assert _lines(outputs["quickstart"]) == _lines(outputs["jax_quickstart"])
    assert len(_lines(outputs["quickstart"])) == 6


def _backend_lines(lines):
    return [line for line in lines if line.startswith("  backend ")]


def test_elastic_failover_plans_as_the_jax_example(outputs):
    """The same plan and checks, line for line, up to the backends (whose
    names differ), and the same last line: D3(3,7), 147 chips."""
    got, want = _lines(outputs["elastic_failover"]), _lines(outputs["jax_elastic_failover"])
    head = [line for line in want if not line.startswith("  backend ")]
    assert [line for line in got if not line.startswith("  backend ")] == head
    assert "largest embeddable survivor network: D3(3,7) = 147 chips" in "\n".join(got)
    first = got.index(_backend_lines(got)[0])
    assert got[first - 1] == "rewritten all-to-all bit-exact vs native guest lowering ✓"
    assert len(_backend_lines(got)) == len(available_backends()) == 5


@pytest.mark.parametrize("name", available_backends())
def test_elastic_failover_backend_is_bit_exact(outputs, name):
    """One line for each backend the port registers, in registration
    order: it replayed the optimized rewrite to the ``reference`` bits."""
    lines = _backend_lines(_lines(outputs["elastic_failover"]))
    line = lines[available_backends().index(name)]
    assert re.fullmatch(rf"  backend {re.escape(name)} +\(\w+\) replays the optimized rewrite "
                        r"bit-exact ✓", line), line


def _served(text):
    """{rid: tokens} from an example's lines."""
    got = {}
    for line in _lines(text):
        m = SERVED.match(line)
        if m:
            got[int(m.group(1))] = [int(t) for t in m.group(2).strip("[]").split(",")]
    return got


def _example(name):
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  EXAMPLES / "torch" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_serve_moe_gives_the_jax_examples_tokens(outputs, capsys):
    """On the JAX example's weights the port's example serves each request
    the tokens the JAX example serves it."""
    import jax

    from repro.configs import get_smoke_config as j_smoke
    from repro.models import model as JM
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.convert import params_from_jax

    cfg = get_smoke_config("mixtral-8x7b")
    params = params_from_jax(JM.init_params(jax.random.key(0), j_smoke("mixtral-8x7b")), cfg,
                             device="cpu")
    got = _example("serve_moe").main(["--device", "cpu"], params=params)
    want = _served(outputs["jax_serve_moe"])
    assert sorted(want) == list(range(5))
    assert got == want
    assert _served(capsys.readouterr().out) == want


def test_serve_moe_standalone_serves_every_request(outputs):
    """On its own random weights: 5 requests, 8 tokens each, in the
    vocabulary."""
    got = _served(outputs["serve_moe"])
    assert sorted(got) == list(range(5))
    assert all(len(tokens) == 8 and all(0 <= t < 256 for t in tokens) for tokens in got.values())
    assert re.fullmatch(r"5 requests served in \d+ engine steps \(continuous batching over 3 "
                        r"slots\)", _lines(outputs["serve_moe"])[-1])


def test_train_tinyllama_resumes_to_a_straight_runs_loss(outputs, tmp_path):
    """Trained to half, restarted with ``--restore`` and finished: the final
    loss is that of one straight run of as many steps, and the checkpoints
    lie where ``--ckpt-dir`` says."""
    m = re.search(r"final loss after restart-resume: (\d+\.\d+)", outputs["train_tinyllama"])
    assert m, outputs["train_tinyllama"]
    assert "restored step=2" in outputs["train_tinyllama"]
    assert sorted(p.name for p in outputs["ckpt_dir"].iterdir()) == ["step_00000002",
                                                                     "step_00000004"]
    straight = launcher.main(["--arch", "tinyllama-1.1b", "--smoke", "--batch", "8", "--seq", "64",
                              "--steps", str(TRAIN_STEPS), "--ckpt-dir", str(tmp_path),
                              "--device", "cpu"])
    assert np.isfinite(straight)
    assert abs(float(m.group(1)) - straight) <= RESTART_TOL, (m.group(1), straight)
