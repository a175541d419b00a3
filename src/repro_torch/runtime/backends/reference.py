"""Pure-NumPy reference backend: host-side replay of a CollectiveProgram.

No devices — the ground truth the cuda_fused backend is differential-
tested against (on the card too, where it is the only reference), and a
host-side validator for schedules lowered for hardware this process
doesn't have. Arrays carry the GLOBAL view: index 0
is the device (= router id) axis.

Semantics mirror ``runtime.program``'s synchronous-step contract: all
stages of one step group read the pre-group values, then their writes land
together.

Emulated (guest-on-host) programs — ``program.active_devices`` set — are
replayed on host-sized arrays. This backend is the enforcement point of the
idle-isolation guarantee: after replay it ASSERTS that slots belonging to
idle host devices were never touched (inputs pass through for allreduce/
broadcast; outputs stay zero for alltoall/matmul). A violated assertion
means the rewrite or a backend broke the contract, not user error.

Every ``run_*`` entry point also accepts an ``optimize.OptimizedProgram``:
the replay then applies the fused group tables (one advanced-indexing
operation per conflict-free step group — the §3 all-to-all collapses to a
single scatter) instead of the per-stage loop, with identical results and
the same idle assertions.
"""

from __future__ import annotations

import numpy as np

from repro_torch.runtime import optimize as _opt
from repro_torch.runtime.program import (
    CollectiveProgram,
    LocalContract,
    Match,
    Perm,
    ReduceCombine,
    check_kind as _check_kind,
)


def _assert_idle_untouched(program: CollectiveProgram, got: np.ndarray,
                           want: np.ndarray, axes=(0,)) -> None:
    """Emulated programs: idle host devices' slots must be bit-identical to
    ``want`` (the pre-replay values, or zeros for freshly-built outputs)."""
    if program.active_devices is None:
        return
    idle = ~program.active_mask_np
    for ax in axes:
        sel = [slice(None)] * got.ndim
        sel[ax] = idle
        if not np.array_equal(got[tuple(sel)], want[tuple(sel)]):
            raise AssertionError(
                f"idle device slots were touched on axis {ax} of a "
                f"{program.kind!r} emulation replay ({program.name})"
            )


class NumpyReferenceBackend:
    """Replay programs on host arrays (global view, device axis first)."""

    name = "reference"

    # ------------------------------------------------------------ alltoall
    def run_alltoall(self, x: np.ndarray, program: CollectiveProgram) -> np.ndarray:
        """x: (n, n, ...) with x[i, j] the chunk device i sends to device j;
        returns out[i, j] = chunk received by i FROM j (= x[j, i]).

        Emulated programs: only active (i, j) slots are filled; rows and
        columns of idle devices stay zero (asserted)."""
        opt = program if isinstance(program, _opt.OptimizedProgram) else None
        program = _opt.as_program(program)
        _check_kind(program, "alltoall")
        n = program.n
        if x.shape[0] != n or x.shape[1] != n:
            raise ValueError(f"expected leading dims ({n}, {n}), got {x.shape}")
        if opt is not None:
            out = _opt.np_alltoall(x, opt)
        else:
            out = np.zeros_like(x)
            for op in program.comm_stages:
                assert isinstance(op, Perm)
                # sender s ships chunk x[s, d] to d, who files it under index
                # s — pairs-based so partial (emulated) perms never touch
                # idle slots.
                out[op.dst_np, op.src_np] = x[op.src_np, op.dst_np]
        _assert_idle_untouched(program, out, np.zeros_like(out), axes=(0, 1))
        return out

    def run_alltoall_compute(
        self, x: np.ndarray, program: CollectiveProgram, compute=None
    ) -> np.ndarray:
        """Fused dispatch+compute round trip, ground truth for a per-stage
        backend's ``alltoall_compute`` (the MoE dispatch path): every chunk x[i, j] is processed AT
        its destination j and returned to sender i, so
        out[i, j] = compute_j(x[i, j]) — NOT the all-to-all transpose.
        ``compute(d, chunks)`` maps destination id d and the (k, ...) stack
        of chunks arriving there to the processed (k, ...) stack;
        ``compute=None`` is the identity round trip.

        Emulated programs: only active (i, j) slots are processed; rows and
        columns of idle devices stay zero (asserted)."""
        program = _opt.as_program(program)
        _check_kind(program, "alltoall")
        n = program.n
        if x.shape[0] != n or x.shape[1] != n:
            raise ValueError(f"expected leading dims ({n}, {n}), got {x.shape}")
        act = (np.flatnonzero(program.active_mask_np)
               if program.active_devices is not None else np.arange(n))
        out = np.zeros_like(x)
        for j in act:
            chunks = x[act, j]
            out[act, j] = chunks if compute is None else compute(int(j), chunks)
        _assert_idle_untouched(program, out, np.zeros_like(out), axes=(0, 1))
        return out

    # ----------------------------------------------------------- allreduce
    def run_allreduce(self, x: np.ndarray, program: CollectiveProgram) -> np.ndarray:
        """x: (n, ...) -> (n, ...) with every active row the sum over active
        rows; idle rows pass through unchanged (asserted)."""
        opt = program if isinstance(program, _opt.OptimizedProgram) else None
        program = _opt.as_program(program)
        _check_kind(program, "allreduce")
        x = np.asarray(x)
        if opt is not None:
            val = _opt.np_allreduce(x, opt)
        else:
            val = x.copy()
            for st in program.comm_stages:
                assert isinstance(st, ReduceCombine)
                recv = np.zeros_like(val)
                for s, d in st.link_pairs:
                    recv[d] = val[s]
                recv[st.self_mask_np] += val[st.self_mask_np]
                val = val + recv
        _assert_idle_untouched(program, val, x)
        return val

    # ----------------------------------------------------------- broadcast
    def run_broadcast(
        self, x: np.ndarray, program: CollectiveProgram, *, pipelined: bool = False
    ) -> np.ndarray:
        """Single-round programs: x (n, ...) -> root's row everywhere.
        Multi-round (pipelined wave) programs: x (R, n, ...), wave w's tree
        moves slice x[w]. ``pipelined=True`` replays in start_step order —
        results must be identical to barrier order (the IR's pipelined
        conflict-freedom, projected onto data). Optimized programs replay
        their fused barrier-order groups regardless of ``pipelined`` (the
        results coincide by the same conflict-freedom)."""
        opt = program if isinstance(program, _opt.OptimizedProgram) else None
        program = _opt.as_program(program)
        _check_kind(program, "broadcast")
        waves = program.num_rounds > 1
        x = np.asarray(x)
        if waves and x.shape[0] != program.num_rounds:
            raise ValueError(
                f"expected leading wave dim {program.num_rounds}, got {x.shape}"
            )
        if opt is not None:
            val = _opt.np_broadcast(x, opt)
        else:
            val = x.copy()
            for group in program.step_groups(pipelined=pipelined):
                pre = val.copy()
                for st in group:
                    assert isinstance(st, Match)
                    if waves:
                        val[st.round_index][st.dst_np] = pre[st.round_index][st.src_np]
                    else:
                        val[st.dst_np] = pre[st.src_np]
        _assert_idle_untouched(program, val, x, axes=(1,) if waves else (0,))
        return val

    # -------------------------------------------------------------- matmul
    def run_matmul(
        self, B: np.ndarray, A: np.ndarray, program: CollectiveProgram
    ) -> np.ndarray:
        """§2 block product via program replay: B, A are (N·X, N·X)
        matrices; returns B @ A computed by the paper's rounds. Emulated
        programs scatter the guest's blocks to their host devices (grid
        metadata is the GUEST grid), replay host-sized, and gather back."""
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

    def matmul_blocks(
        self, b: np.ndarray, a: np.ndarray, program: CollectiveProgram
    ) -> np.ndarray:
        """Per-router block replay: b, a (n, X, X) in router-id order ->
        c (n, X, X). The per-device state is (val, acc) driven by the
        LocalContract stages; see runtime.program.LOCAL_FNS."""
        opt = program if isinstance(program, _opt.OptimizedProgram) else None
        program = _opt.as_program(program)
        _check_kind(program, "matmul")
        n = program.n
        if b.shape != a.shape or b.shape[0] != n:
            raise ValueError(f"expected blocks (n={n}, X, X), got {b.shape} {a.shape}")
        if opt is not None:
            c = _opt.np_matmul_blocks(b, a, opt)
            _assert_idle_untouched(program, c, np.zeros_like(c))
            return c
        dtype = np.result_type(b, a)
        val = np.zeros_like(b, dtype=dtype)
        acc = np.zeros_like(val)
        c = np.zeros_like(val)
        for group in program.step_groups():
            if isinstance(group[0], LocalContract):
                (st,) = group
                if st.fn == "load_b":
                    val = b.astype(dtype).copy()
                    acc = np.zeros_like(val)
                elif st.fn == "mul_a":
                    val = np.einsum("nab,nbc->nac", val, a.astype(dtype))
                    acc = np.zeros_like(val)
                elif st.fn == "promote":
                    val = acc
                    acc = np.zeros_like(val)
                elif st.fn == "store_c":
                    mask = st.mask_np
                    c[mask] = val[mask]
                continue
            pre = val.copy()
            for st in group:
                if isinstance(st, Match):
                    src = [s for s, _ in st.pairs]
                    dst = [d for _, d in st.pairs]
                    val[dst] = pre[src]
                elif isinstance(st, ReduceCombine):
                    for s, d in st.pairs:
                        acc[d] = acc[d] + pre[s]
                else:  # pragma: no cover - lowering never emits Perm here
                    raise TypeError(f"unexpected stage {st!r} in matmul program")
        _assert_idle_untouched(program, c, np.zeros_like(c))
        return c
