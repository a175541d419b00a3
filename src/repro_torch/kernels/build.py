"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is one kernel family with a plain C interface
(the Hopper bodies share ``csrc/hopper.cuh``). It is compiled for
``sm_90a`` into ``build/repro_torch_kernels/`` at the root of the
checkout (listed in ``.gitignore``) the first time a wrapper needs it,
under a name that carries a hash of the source, the shared headers and
the flags, so an edited source is rebuilt and an unchanged one is loaded
as it is.
``build_all()`` starts one ``nvcc`` per source at once and waits for all.
Nothing is built at import time, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("reduce_rounds", "block_matmul", "flash_attention", "ring_exchange")
# No fast-math: the reduce kernels must be bit-exact with the plain replay.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_PP, _PI = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
#: C signatures of every exported function: name -> argument types (all return int).
SIGNATURES = {
    "reduce_rounds": {
        "reduce_rounds_slab_floats": [],
        "reduce_rounds_staged_limits": [_PI, _PI, _PI],
        "reduce_rounds_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _LL, _I, _I, _I, _P],
        "reduce_rounds_staged_launch": [_P, _P, _P, _P, _I, _I, _I, _LL, _I, _I, _I, _I, _P],
    },
    "block_matmul": {
        "block_matmul_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    },
    "flash_attention": {
        "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, *[_LL] * 12,
                                   _I, _I, _F, _I, _I, _P],
        "flash_attention_smem_bytes": [_I, _I, _I],
    },
    "ring_exchange": {
        "ring_handle_bytes": [],
        "ring_window_create": [_LL, _I, _PP, _P],
        "ring_window_open": [_P, _I, _I, _P],
        "ring_window_close": [_P],
        "ring_put": [_P, _I, _I, _P, _LL, _LL, _LL, _P],
        "ring_signal": [_P, _I, _I, _LL, _P],
        "ring_wait_add": [_P, _I, _I, _P, _P, _LL, _I, _LL, _LL, _P],
        "ring_error": [_P, _P, _PI],
    },
}

_lock = threading.Lock()


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or str(pathlib.Path(cuda_home) / "bin" / "nvcc")
    if not pathlib.Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> pathlib.Path:
    """The library's path, named by a hash of its source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    parts = [(CSRC / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start ``nvcc`` for one source into a temporary file beside its target;
    None when the library is already built."""
    target = library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return target, tmp, cmd, proc


def _finish(started) -> str:
    target, tmp, cmd, proc = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, target)  # atomic: a concurrent builder sees all or nothing
    return log


def build_all(names=SOURCES) -> dict[str, str]:
    """Build every listed source that is not built yet, one ``nvcc`` each,
    all running at once. Returns each new build's compiler log (with
    ``-Xptxas -v``: registers, shared memory and spills per kernel)."""
    with _lock:
        started = {name: _start(name) for name in names}
        logs = {}
        try:
            for name, job in started.items():
                if job is not None:
                    logs[name] = _finish(job)
        finally:
            for job in started.values():
                if job is not None and job[3].poll() is None:
                    job[3].kill()
                    job[3].wait()
                    pathlib.Path(job[1]).unlink(missing_ok=True)
        return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with its C signatures set,
    building it first if needed."""
    build_all((name,))
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")
