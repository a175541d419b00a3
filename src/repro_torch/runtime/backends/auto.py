"""Auto backend: route every call through the price-driven autotuner.

The port of ``repro.runtime.backends.auto``. ``AutoBackend`` satisfies the
backend contract by DELEGATING: each call asks ``runtime.autotune`` for
the cheapest strategy at this call site's ``TuneKey`` (kind, D3 topology,
message bytes, dtype, site) and dispatches to the strategy's executor —

  * ``fused``         the ``optimize()`` table replay in plain torch (the
                      whole-array ``run_*`` of ``torch_dist`` on an
                      optimized program, which communicate nothing)
  * ``cuda_fused``    the ``CudaFusedBackend`` (its CUDA kernels)
  * ``sendrecv``      the exported per-device send/recv trace replayed by
                      the NumPy interpreter
  * ``loop``          per-stage replay on ``torch_dist``
  * ``overlap``       the same program in ``start_step`` order
  * ``overlap_fused`` the wave-ordered replay (all-to-all: one gather and
                      one scatter, and the dispatch+compute+combine round
                      trip of ``alltoall_compute``)
  * ``native``        ``torch.distributed``'s own collective
                      (``all_to_all_single`` / ``all_reduce`` /
                      ``broadcast``)

Whole-array ``run_*`` calls tune at ``site="global"`` and run in this one
process: the strategies that need a process group (``loop``,
``overlap``, ``overlap_fused``, ``native``) degrade to ``fused``, as the
JAX package degrades them where it has too few devices. They take numpy
arrays or tensors and always return a tensor on the backend's ``device``
(the card unless ``"cpu"`` is given), whichever strategy ran. The
per-shard methods run on every rank of a process group with that rank's
shard, on a device the group carries, as ``TorchDistBackend``'s do; they
tune at ``site="shard"`` over that group, and every rank of it gets the
same decision (``Autotuner.decide``). Results are bit-identical across
strategies on integer-valued floats (the backend contract), so the tuner
is free to switch on speed alone.

Emulated (``active_devices``) programs never dispatch to ``native``: the
group's collective would mix idle ranks into the result.
``get_backend("auto")`` instantiates this class.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.runtime import autotune as _at
from repro_torch.runtime import optimize as _opt
from repro_torch.runtime.program import CollectiveProgram, check_kind as _check_kind


def _chunk_bytes(x, kind: str, site: str = "shard", n: int = 1) -> int:
    """Message bytes at this site: per-destination capacity chunk for
    all-to-all, the full per-device vector otherwise.

    Both are ``site``-dependent because the buffers differ by a device
    axis: a shard-site ``x`` is this rank's (n, chunk...) all-to-all buffer
    or its vector, while a global ``x`` holds all ``n`` devices' — (n, n,
    chunk...) for all-to-all, n vectors otherwise — and keys on one
    device's share, the bytes ``_measure_closure`` times per device and
    ``models.moe`` keys for the same exchange. (The JAX package keys a
    global all-reduce or broadcast on the whole array, n times the vector
    its measurement then builds per device; the port keys the vector.)"""
    if isinstance(x, torch.Tensor):
        itemsize, size = x.element_size(), x.numel()
    else:
        x = np.asarray(x)
        itemsize, size = x.dtype.itemsize, x.size
    if kind == "alltoall":
        div = x.shape[0] * (x.shape[1] if site == "global" else 1)
    else:
        div = n if site == "global" else 1
    return max(1, int(size) // max(1, div)) * itemsize


def delegate(strategy: str, program, device: torch.device):
    """(backend instance, program form) that runs ``strategy``; ``native``
    has no backend (the callers issue the collective)."""
    prog = _opt.as_program(program)
    if strategy == "cuda_fused":
        from repro_torch.runtime.backends.cuda_fused import CudaFusedBackend

        return CudaFusedBackend(device=device), _opt.optimize(prog)
    if strategy == "sendrecv":
        from repro_torch.runtime.backends.sendrecv import SendRecvBackend

        return SendRecvBackend(), prog
    if strategy in ("fused", "loop", "overlap", "overlap_fused"):
        # torch_dist's whole-array run_* replay an optimized program's tables
        # on the array's device with no communication: the fused strategy
        from repro_torch.runtime.backends.torch_dist import TorchDistBackend

        be = TorchDistBackend(overlap=strategy == "overlap",
                              overlap_fused=strategy == "overlap_fused")
        return be, (_opt.optimize(prog) if strategy == "fused" else prog)
    raise ValueError(f"no backend runs the {strategy!r} strategy")


@dataclasses.dataclass(frozen=True)
class AutoBackend:
    """Strategy-per-call-site dispatcher (see module docstring).

    ``tuner=None`` uses the process-wide ``autotune.get_autotuner(device)``
    — pass an explicit ``Autotuner`` to pin mode, cache and device (tests,
    launchers)."""

    tuner: object | None = None
    device: torch.device | str = "cuda"
    name: str = "auto"

    def __post_init__(self):
        device = torch.device(self.device)
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"auto runs on 'cuda' or 'cpu', not {device}")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("auto needs a CUDA card and found none; "
                               "pass device='cpu' for the CPU")
        object.__setattr__(self, "device", device)

    def _tuner(self) -> _at.Autotuner:
        return self.tuner if self.tuner is not None else _at.get_autotuner(self.device)

    def _decide(self, kind: str, program: CollectiveProgram, nbytes: int, dtype, site: str,
                compute_us: int = 0, group=None, carrier=None) -> _at.Decision:
        return self._tuner().decide(
            kind, _at.layout_for(program.n), nbytes, dtype=dtype, site=site,
            grid=program.grid if kind == "matmul" else None,
            emulated=program.active_devices is not None, compute_us=compute_us,
            group=group, carrier=carrier)

    @staticmethod
    def _global_strategy(dec: _at.Decision) -> str:
        """A whole-array call runs in this one process: a decision naming a
        strategy that needs a process group (an analytic or forced one),
        or the NumPy trace replay of a dtype numpy lacks, degrades to the
        fused replay, which runs anywhere."""
        if dec.strategy in _at.GROUP_STRATEGIES or (
                dec.strategy == "sendrecv" and _at._numpy_dtype(dec.key.dtype) is None):
            return "fused"
        return dec.strategy

    # ------------------------------------------------- whole-array wrappers
    def _run(self, kind: str, program, *arrays, **run_kw) -> torch.Tensor:
        prog = _opt.as_program(program)
        _check_kind(prog, kind)
        arrays = tuple(torch.as_tensor(a, device=self.device) for a in arrays)
        x = arrays[0]
        dec = self._decide(kind, prog, self._global_bytes(kind, prog, x), x.dtype, "global")
        be, p = delegate(self._global_strategy(dec), prog, self.device)
        if be.name == "sendrecv":
            arrays = tuple(a.cpu().numpy() for a in arrays)
        out = getattr(be, f"run_{kind}")(*arrays, p, **run_kw)
        return torch.as_tensor(out, device=self.device)

    @staticmethod
    def _global_bytes(kind: str, prog, x: torch.Tensor) -> int:
        if kind != "matmul":
            return _chunk_bytes(x, kind, "global", prog.n)
        if prog.grid is None:
            return 0
        from repro_torch.core.matmul import MatmulGrid

        X = x.shape[0] // MatmulGrid(*prog.grid).n
        return X * X * x.element_size()

    def run_alltoall(self, x, program) -> torch.Tensor:
        return self._run("alltoall", program, x)

    def run_allreduce(self, x, program) -> torch.Tensor:
        return self._run("allreduce", program, x)

    def run_broadcast(self, x, program, *, pipelined: bool = False) -> torch.Tensor:
        return self._run("broadcast", program, x, pipelined=pipelined)

    def run_matmul(self, B, A, program) -> torch.Tensor:
        return self._run("matmul", program, B, A)

    # ---------------------------------------------------------- per-shard
    def alltoall(self, x: torch.Tensor, group, program) -> torch.Tensor:
        from repro_torch.dist.collectives import native_all_to_all

        prog = _opt.as_program(program)
        _check_kind(prog, "alltoall")
        dec = self._decide("alltoall", prog, _chunk_bytes(x, "alltoall"), x.dtype, "shard",
                           group=group, carrier=x.device)
        if dec.strategy == "native":
            return native_all_to_all(x, group)
        be, p = delegate(dec.strategy, prog, self.device)
        return be.alltoall(x, group, p)

    def alltoall_compute(self, x: torch.Tensor, group, program, compute=None,
                         compute_us: int = 0) -> torch.Tensor:
        """Round trip out[j] = compute_j(x[j]) (see ``TorchDistBackend.
        alltoall_compute``), tuned as a full pipeline when the caller
        passes its ``compute_us`` estimate. Strategies other than
        ``overlap_fused`` take the sequential form: dispatch all-to-all,
        one batched ``compute`` over all n arrivals, combine all-to-all."""
        from repro_torch.dist.collectives import native_all_to_all

        prog = _opt.as_program(program)
        _check_kind(prog, "alltoall")
        dec = self._decide("alltoall", prog, _chunk_bytes(x, "alltoall"), x.dtype, "shard",
                           compute_us, group=group, carrier=x.device)
        if dec.strategy == "overlap_fused":
            be, p = delegate(dec.strategy, prog, self.device)
            return be.alltoall_compute(x, group, p, compute)
        if dec.strategy == "native":
            def a2a(v):
                return native_all_to_all(v, group)
        else:
            be, p = delegate(dec.strategy, prog, self.device)

            def a2a(v):
                return be.alltoall(v, group, p)
        recv = a2a(x)
        return a2a(recv if compute is None else compute(recv))

    def allreduce(self, x: torch.Tensor, group, program) -> torch.Tensor:
        prog = _opt.as_program(program)
        _check_kind(prog, "allreduce")
        dec = self._decide("allreduce", prog, _chunk_bytes(x, "allreduce"), x.dtype, "shard",
                           group=group, carrier=x.device)
        if dec.strategy == "native":
            out = x.clone()
            dist.all_reduce(out, group=group)
            return out
        be, p = delegate(dec.strategy, prog, self.device)
        return be.allreduce(x, group, p)

    def broadcast(self, x: torch.Tensor, group, program, *, pipelined: bool = False
                  ) -> torch.Tensor:
        from repro_torch.runtime.backends.torch_dist import global_rank

        prog = _opt.as_program(program)
        _check_kind(prog, "broadcast")
        dec = self._decide("broadcast", prog, _chunk_bytes(x, "broadcast"), x.dtype, "shard",
                           group=group, carrier=x.device)
        if dec.strategy == "native" and prog.num_rounds == 1:
            out = x.clone()
            dist.broadcast(out, src=global_rank(group, prog.root or 0), group=group)
            return out
        be, p = delegate(dec.strategy if dec.strategy != "native" else "loop", prog,
                         self.device)
        return be.broadcast(x, group, p, pipelined=pipelined)

    def matmul(self, b: torch.Tensor, a: torch.Tensor, group, program) -> torch.Tensor:
        prog = _opt.as_program(program)
        _check_kind(prog, "matmul")
        dec = self._decide("matmul", prog, b.numel() * b.element_size(), b.dtype, "shard",
                           group=group, carrier=b.device)
        be, p = delegate(dec.strategy, prog, self.device)
        return be.matmul(b, a, group, p)
