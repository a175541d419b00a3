"""Send/recv trace backend: replay exported ``DeviceTrace``s in pure NumPy.

The port of ``repro.runtime.backends.sendrecv``: a host backend, like
``reference``, that never touches a card.

The consuming half of the collective compiler (``runtime.export``): every
``run_*`` call compiles its program to a per-device send/recv op trace —
memoized and statically re-validated once per program — and then executes
THE TRACE, never the program stages. What an NCCL-style runtime would do
with the exported JSON, this backend does on host arrays, which makes the
export format itself differential-testable:
``sendrecv`` must be bit-identical to ``reference`` on every program
(native, optimized, emulated, combined — the conformance suite in
``tests/test_torch_runtime.py`` asserts it against ``reference`` and
``cuda_fused``).

Replay semantics follow the trace contract: groups execute sequentially;
within a group every ``send`` payload is read (and copied) from the
pre-group buffers, then recv/reduce/copy/contract ops apply in per-device
op order. ``contract`` ops batch into one ``einsum`` over the contracting
devices so the §2 block product is bit-identical to the reference replay.
Idle devices of emulated/combined programs have no ops at all, so idle
pass-through (inputs unchanged for allreduce/broadcast, outputs zero for
alltoall/matmul) holds structurally.

No devices. ``OptimizedProgram``s are accepted anywhere a program
is (the trace of the fused form is the trace of its source program).
"""

from __future__ import annotations

import functools

import numpy as np

from repro_torch.runtime import export as _export
from repro_torch.runtime import optimize as _opt
from repro_torch.runtime.program import CollectiveProgram, check_kind as _check_kind


@functools.lru_cache(maxsize=None)
def _compiled(prog: CollectiveProgram):
    """(validated trace, replay groups) for one program. Groups are the
    trace ops bucketed by group id, device-major — per-device op order is
    preserved, which is the only order the replay contract requires."""
    trace = _export.validate(_export.export(prog))
    groups: list[list[tuple[int, _export.TraceOp]]] = [
        [] for _ in range(trace.num_groups)
    ]
    for dev, ops in enumerate(trace.devices):
        for op in ops:
            groups[op.group].append((dev, op))
    return trace, tuple(tuple(g) for g in groups)


def _replay(trace, groups, bufs: dict[str, np.ndarray], dtype=None) -> None:
    """Execute the trace in place on the named buffers."""
    waves = trace.kind == "broadcast" and trace.num_rounds > 1
    a_cast = None  # lazily-cast A blocks for contract ops
    for gops in groups:
        payloads: dict[tuple[int, int], np.ndarray] = {}
        pre_val = None
        contract_devs: list[int] = []
        # pass 1: read every send payload from the pre-group buffers
        # (copies — a later write must not alias an in-flight packet),
        # snapshot ``val`` if an off-and-on reduce needs the pre value,
        # and collect the group's contracting devices.
        for dev, op in gops:
            if op.op == "send":
                if trace.kind == "alltoall":
                    payloads[dev, op.peer] = bufs["x"][dev, op.slot].copy()
                elif waves:
                    payloads[dev, op.peer] = bufs["val"][op.slot, dev].copy()
                else:
                    payloads[dev, op.peer] = bufs[op.buf][dev].copy()
            elif op.op == "reduce" and op.src == "val" and pre_val is None:
                pre_val = bufs["val"].copy()
            elif op.op == "contract":
                contract_devs.append(dev)
        if contract_devs:
            if a_cast is None:
                a_cast = bufs["a"].astype(dtype)
            idx = np.asarray(contract_devs)
            bufs["val"][idx] = np.einsum(
                "nab,nbc->nac", bufs["val"][idx], a_cast[idx])
        # pass 2: land the writes in per-device op order
        tmp: dict[int, np.ndarray] = {}
        for dev, op in gops:
            if op.op == "recv":
                v = payloads[op.peer, dev]
                if op.buf == "tmp":
                    tmp[dev] = v
                elif trace.kind == "alltoall":
                    bufs["out"][dev, op.slot] = v
                elif waves:
                    bufs["val"][op.slot, dev] = v
                else:
                    bufs[op.buf][dev] = v
            elif op.op == "reduce":
                src = tmp[dev] if op.src == "tmp" else pre_val[dev]
                tgt = bufs[op.buf]
                tgt[dev] = tgt[dev] + src
            elif op.op == "copy":
                if op.src == "x":       # alltoall self chunk
                    bufs["out"][dev, op.slot] = bufs["x"][dev, op.slot]
                elif op.src == "zero":  # accumulator reset
                    bufs[op.buf][dev] = 0
                else:
                    bufs[op.buf][dev] = bufs[op.src][dev]


class SendRecvBackend:
    """Replay exported send/recv traces on host arrays (global view)."""

    name = "sendrecv"

    @staticmethod
    def trace(program) -> "_export.DeviceTrace":
        """The validated :class:`~repro_torch.runtime.export.DeviceTrace` this
        backend replays for ``program`` (exposed for inspection/export)."""
        return _compiled(_opt.as_program(program))[0]

    # ------------------------------------------------------------ alltoall
    def run_alltoall(self, x, program) -> np.ndarray:
        prog = _opt.as_program(program)
        _check_kind(prog, "alltoall")
        x = np.asarray(x)
        n = prog.n
        if x.shape[0] != n or x.shape[1] != n:
            raise ValueError(f"expected leading dims ({n}, {n}), got {x.shape}")
        trace, groups = _compiled(prog)
        out = np.zeros_like(x)
        _replay(trace, groups, {"x": x, "out": out})
        return out

    # ----------------------------------------------------------- allreduce
    def run_allreduce(self, x, program) -> np.ndarray:
        prog = _opt.as_program(program)
        _check_kind(prog, "allreduce")
        trace, groups = _compiled(prog)
        val = np.asarray(x).copy()
        _replay(trace, groups, {"val": val})
        return val

    # ----------------------------------------------------------- broadcast
    def run_broadcast(self, x, program, *, pipelined: bool = False) -> np.ndarray:
        """``pipelined`` is accepted for contract parity: the trace replays
        its barrier groups either way, bit-identical to start_step order by
        the IR's pipelined conflict-freedom (the same coincidence the fused
        replay relies on)."""
        prog = _opt.as_program(program)
        _check_kind(prog, "broadcast")
        trace, groups = _compiled(prog)
        x = np.asarray(x)
        if trace.num_rounds > 1 and x.shape[0] != trace.num_rounds:
            raise ValueError(
                f"expected leading wave dim {trace.num_rounds}, got {x.shape}")
        val = x.copy()
        _replay(trace, groups, {"val": val})
        return val

    # -------------------------------------------------------------- matmul
    def run_matmul(self, B, A, program) -> np.ndarray:
        from repro_torch.core.matmul import MatmulGrid, gather_blocks, scatter_blocks
        from repro_torch.runtime.rewrite import gather_guest, scatter_guest

        prog = _opt.as_program(program)
        _check_kind(prog, "matmul")
        if prog.grid is None:
            raise ValueError("matmul program lacks grid metadata")
        g = MatmulGrid(*prog.grid)
        b = scatter_guest(scatter_blocks(g, np.asarray(B)), prog)
        a = scatter_guest(scatter_blocks(g, np.asarray(A)), prog)
        c = self.matmul_blocks(b, a, program)
        return gather_blocks(g, gather_guest(c, prog))

    def matmul_blocks(self, b, a, program) -> np.ndarray:
        prog = _opt.as_program(program)
        _check_kind(prog, "matmul")
        b, a = np.asarray(b), np.asarray(a)
        n = prog.n
        if b.shape != a.shape or b.shape[0] != n:
            raise ValueError(f"expected blocks (n={n}, X, X), got {b.shape} {a.shape}")
        trace, groups = _compiled(prog)
        dtype = np.result_type(b, a)
        val = np.zeros(b.shape, dtype)
        _replay(trace, groups,
                {"b": b, "a": a, "val": val, "acc": np.zeros_like(val),
                 "c": (c := np.zeros_like(val))}, dtype=dtype)
        return c
