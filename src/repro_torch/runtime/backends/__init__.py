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
    default; ``device="cpu"`` runs the kernels' plain torch versions. Its
    ``allreduce_shard`` is the per-shard §4 all-reduce on K5.
  * ``sendrecv`` — a pure-NumPy host replay of the program's exported
    send/recv trace (``runtime.export``): no devices; it executes the
    trace, never the program stages.
  * ``torch_dist`` — the per-shard replay over ``torch.distributed``: one
    ``batch_isend_irecv`` per communication stage on a process group of
    ``program.n`` ranks (``overlap``/``overlap_fused`` orders, the
    wave-pipelined ``alltoall_compute``), plus the whole-array ``run_*``
    wrappers every rank calls with the same global array.
  * ``auto`` — asks the autotuner (``runtime.autotune``) for the cheapest
    of the strategies above at each call site and delegates to it; its
    whole-array ``run_*`` run in one process on its ``device`` (the card
    unless ``"cpu"`` is given), its per-shard methods on a process group,
    whose ranks agree on every decision.

Emulated (``runtime.rewrite.emulate``) and combined (``runtime.combine``)
programs are ordinary programs with ``active_devices`` set: every backend
replays them with idle ranks passing through.
"""

from __future__ import annotations


def _load_reference():
    from repro_torch.runtime.backends.reference import NumpyReferenceBackend

    return NumpyReferenceBackend


def _load_cuda_fused():
    from repro_torch.runtime.backends.cuda_fused import CudaFusedBackend

    return CudaFusedBackend


def _load_sendrecv():
    from repro_torch.runtime.backends.sendrecv import SendRecvBackend

    return SendRecvBackend


def _load_torch_dist():
    from repro_torch.runtime.backends.torch_dist import TorchDistBackend

    return TorchDistBackend


def _load_auto():
    from repro_torch.runtime.backends.auto import AutoBackend

    return AutoBackend


#: name -> lazy class loader (lazy so importing the registry loads no backend).
_REGISTRY = {
    "reference": _load_reference,
    "cuda_fused": _load_cuda_fused,
    "sendrecv": _load_sendrecv,
    "torch_dist": _load_torch_dist,
    "auto": _load_auto,
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
