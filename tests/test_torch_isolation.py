"""The port stands alone: it imports neither jax nor the JAX package, builds
nothing at import time, and never moves to the CPU on its own."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.runtime.backends import get_backend
from repro_torch.runtime.backends.cuda_fused import CudaFusedBackend

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path}: relative import"
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), f"{path} imports {name}"


def _run(code: str) -> None:
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                   timeout=120)


def test_importing_every_port_module_loads_no_jax():
    _run(
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import build\n"
        "assert build.load.cache_info().currsize == 0, 'a kernel was loaded at import'\n"
    )


def test_package_imports_are_light():
    _run(
        "import sys\n"
        "import repro_torch.runtime, repro_torch.runtime.backends, repro_torch.kernels\n"
        "loaded = [m for m in sys.modules if m.startswith(('torch', 'repro_torch.runtime.'))]\n"
        "assert loaded == ['repro_torch.runtime.backends'], loaded\n"
    )


def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        CudaFusedBackend()
    with pytest.raises(RuntimeError, match="CUDA card"):
        get_backend("cuda_fused")
    assert CudaFusedBackend(device="cpu").device == torch.device("cpu")


def test_other_devices_are_refused():
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        CudaFusedBackend(device="meta")


def test_model_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("tinyllama-1.1b")
    with pytest.raises(RuntimeError, match="CUDA card"):
        M.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA card"):
        M.init_cache(cfg, 1, 8)
    params = M.init_params(0, cfg, device="cpu")
    assert params["embed"]["table"].device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        Engine(cfg, params, batch_slots=1, max_seq=8)
    assert Engine(cfg, params, batch_slots=1, max_seq=8, device="cpu").device.type == "cpu"


def test_engine_refuses_parameters_on_another_device():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Engine

    cfg = get_smoke_config("tinyllama-1.1b")
    params = M.init_params(0, cfg, device="cpu")
    with pytest.raises(ValueError, match="parameters lie on"):
        Engine(cfg, params, batch_slots=1, max_seq=8, device="meta")


def _refuses_to_move(entry: str, tmp: pathlib.Path) -> None:
    """Each per-shard entry point, given what it cannot run on, raises: none
    of them moves the work to the CPU on its own."""
    from repro_torch.dist import collectives as dc
    from repro_torch.dist.mesh import DeviceLayout
    from repro_torch.core.topology import D3
    from repro_torch.launch.mesh import make_dragonfly_group

    if entry == "make_dragonfly_group":
        with pytest.raises(RuntimeError, match="CUDA card"):
            make_dragonfly_group(0, 8, init_method="file:///nonexistent")
    elif entry == "allreduce_shard":
        with pytest.raises(RuntimeError, match="CUDA card"):
            CudaFusedBackend()
        prog = dc.allreduce_program(DeviceLayout(D3(2, 2)))
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            CudaFusedBackend(device="cpu").allreduce_shard(torch.zeros(8), None, prog)
    else:  # torch_dist on a one-rank gloo group, in a process of its own
        _run(
            "import pytest, torch, torch.distributed as dist\n"
            "from repro_torch.core.topology import D3\n"
            "from repro_torch.dist import collectives as dc\n"
            "from repro_torch.dist.mesh import DeviceLayout\n"
            "from repro_torch.runtime.backends import get_backend\n"
            f"dist.init_process_group('gloo', init_method='file://{tmp}/store',\n"
            "                        rank=0, world_size=1)\n"
            "prog = dc.alltoall_program(DeviceLayout(D3(1, 1)))\n"
            "with pytest.raises(ValueError, match='cannot carry this meta tensor'):\n"
            "    get_backend('torch_dist').alltoall(torch.ones(1, 3, device='meta'), None, prog)\n"
            "dist.destroy_process_group()\n")


@pytest.mark.parametrize("entry", ["make_dragonfly_group", "allreduce_shard", "torch_dist"])
def test_per_shard_entry_points_never_move_to_the_cpu(monkeypatch, tmp_path, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _refuses_to_move(entry, tmp_path)
