"""Pluggable execution backends for ``CollectiveProgram``s.

The backend contract: every backend exposes the four whole-array entry
points

    run_alltoall(x, program)           (n, n, ...) -> (n, n, ...)
    run_allreduce(x, program)          (n, ...)    -> (n, ...)
    run_broadcast(x, program, *,       (n, ...)    -> (n, ...)   single round
                  pipelined=False)     (R, n, ...) -> (R, n, ...) R waves
    run_matmul(B, A, program)          two (N·X, N·X) matrices -> their product

replaying the SAME lowered program, so backends are differential-testable
against each other bit-for-bit on integer-valued floats. Every ``run_*``
also accepts an ``optimize.OptimizedProgram`` and must produce the same
bits for it as for the program it was built from.

Registered backends:

  * ``reference`` — a pure-NumPy host-side replay: no devices.
    The ground truth for differential testing, on the card included.
  * ``cuda_fused`` — replays the OPTIMIZED program form with hand-written
    CUDA kernels on the hot spots: the all-reduce rounds and the §2
    combine groups on the table-driven reduce kernel, the §2 ``mul_a``
    contraction on the batched block-product kernel. Runs on the card by
    default; ``device="cpu"`` runs the kernels' plain torch versions.
"""

from __future__ import annotations


def _load_reference():
    from repro_torch.runtime.backends.reference import NumpyReferenceBackend

    return NumpyReferenceBackend


def _load_cuda_fused():
    from repro_torch.runtime.backends.cuda_fused import CudaFusedBackend

    return CudaFusedBackend


#: name -> lazy class loader (lazy so importing the registry loads no backend).
_REGISTRY = {
    "reference": _load_reference,
    "cuda_fused": _load_cuda_fused,
}


def available_backends() -> tuple[str, ...]:
    """Names of every registered backend, registration order."""
    return tuple(_REGISTRY)


def get_backend(name: str = "cuda_fused", **kwargs):
    """Instantiate a backend by name."""
    loader = _REGISTRY.get(name)
    if loader is None:
        raise ValueError(
            f"unknown backend {name!r}; available: {', '.join(_REGISTRY)}"
        )
    return loader()(**kwargs)
