"""Per-shard backend: replay a CollectiveProgram over ``torch.distributed``.

The per-shard methods (``alltoall``/``alltoall_compute``/``allreduce``/
``broadcast``/``matmul``) run on every rank of a process group of
``program.n`` ranks, rank i = router ``topo.id_router(i)``, each with its
own shard. Each communication stage becomes ONE
``torch.distributed.batch_isend_irecv``: rank r sends to d for each pair
(r, d) of the stage and receives from s for each pair (s, r). A rank that
is no destination of the stage gets zeros, as ``ppermute`` gives it, so the
conflict-freedom ``core.simulator.verify`` proved for the schedule is kept
stage by stage.

``overlap=True`` replays stages in ``start_step`` order instead of round
order, so rounds of a pipelined schedule interleave; for barrier schedules
the two orders coincide.

Emulated (guest-on-host) programs — ``runtime.rewrite.emulate`` output,
``program.active_devices`` set — and combined multi-guest programs
(``runtime.combine``) replay on the full host group with no special
casing: their stages are partial permutations/matchings, idle ranks
receive zeros, and the replay folds an arrival into a rank's state only
where that rank is a listed destination, so idle ranks pass through.

The backend carries tensors on whatever device the group's transport can
carry (gloo: CPU tensors; NCCL: CUDA tensors) and raises, naming both,
when it cannot. It never copies to the host by itself.

The ``run_*`` wrappers are the whole-array form of the backend contract:
every rank calls them with the same global array, replays its own row and
returns the global result gathered on every rank. ``OptimizedProgram``
inputs take the fused table replay on the global array instead
(``runtime.optimize.torch_*``), with no communication, as the JAX
package's wrappers do.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.runtime import optimize as _opt
from repro_torch.runtime.program import (
    CollectiveProgram,
    LocalContract,
    Match,
    Perm,
    ReduceCombine,
    check_kind as _check_kind,
)

#: device types each torch.distributed transport carries for send and recv.
_CARRIES = {"gloo": ("cpu",), "nccl": ("cuda",)}


def check_transport(t: torch.Tensor, group) -> None:
    """Raise if the group's transport cannot carry ``t`` point to point. A
    group built for several (``"cpu:gloo,cuda:nccl"``) carries each."""
    name = str(dist.get_backend(group))
    carried = (tuple(part.split(":")[0] for part in name.split(",")) if ":" in name
               else _CARRIES.get(name, ()))
    if t.device.type not in carried:
        raise ValueError(
            f"the {name} group carries {', '.join(carried) or 'no'} tensors and cannot "
            f"carry this {t.device} tensor; give the backend tensors on a device its "
            f"group carries")


def global_rank(group, group_rank: int) -> int:
    """The global rank of ``group_rank`` in ``group`` (None: the default group)."""
    return group_rank if group is None else dist.get_global_rank(group, group_rank)


def _issue(send: torch.Tensor, pairs, group, rank: int, tag: int):
    """Start one stage's exchange; return its works and the receive buffer
    (zeros where this rank is no destination, as ``ppermute`` gives)."""
    send = send.contiguous()
    ops, recv = [], None
    for s, d in pairs:
        if s == rank and d == rank:
            recv = send.clone()
        elif s == rank:
            ops.append(dist.P2POp(dist.isend, send, global_rank(group, d), group, tag))
        elif d == rank:
            recv = torch.empty_like(send)
            ops.append(dist.P2POp(dist.irecv, recv, global_rank(group, s), group, tag))
    if recv is None:
        recv = torch.zeros_like(send)
    return (dist.batch_isend_irecv(ops) if ops else []), recv


def _wait(works) -> None:
    for w in works:
        w.wait()


def ppermute(x: torch.Tensor, pairs, group, rank: int, tag: int = 0) -> torch.Tensor:
    """One stage: ``lax.ppermute`` over a process group."""
    works, recv = _issue(x, pairs, group, rank, tag)
    _wait(works)
    return recv


def _scatter_rows(out: torch.Tensor, rows: np.ndarray, values: torch.Tensor) -> torch.Tensor:
    """``out[rows] = values`` in one scatter where the last write to a
    repeated row wins, as a stage-by-stage replay would leave it (idle
    emulated ranks file every zero arrival under their own row)."""
    _, last = np.unique(rows[::-1], return_index=True)
    keep = len(rows) - 1 - last
    out[torch.from_numpy(rows[keep]).long().to(out.device)] = \
        values[torch.from_numpy(keep).long().to(values.device)]
    return out


@dataclasses.dataclass(frozen=True)
class TorchDistBackend:
    """One ``batch_isend_irecv`` per communication stage over a process group.

    ``overlap_fused=True`` replays all-to-alls wave by wave (``start_step``
    waves): ONE gather of every outgoing chunk up front, each wave's
    exchanges issued before the previous wave is drained (waited on, and in
    ``alltoall_compute`` computed on and returned), and ONE scatter of every
    arrival at the end. ``alltoall_compute`` always runs that wave
    pipeline: the compute for wave w-1's arrivals trails one wave behind
    wave w's dispatch."""

    overlap: bool = False
    overlap_fused: bool = False
    name: str = "torch_dist"

    def _rank(self, group, program: CollectiveProgram, *tensors) -> int:
        size = dist.get_world_size(group)
        if size != program.n:
            raise ValueError(f"the group has {size} ranks, the program acts on {program.n}")
        for t in tensors:
            check_transport(t, group)
        return dist.get_rank(group)

    def _ordered(self, program: CollectiveProgram):
        return program.pipelined_stages() if self.overlap else program.stages

    # ---------------------------------------------------------- per-shard
    def alltoall(self, x: torch.Tensor, group, program) -> torch.Tensor:
        """All-to-all of per-destination chunks: ``x`` (n, ...) with x[j]
        this rank's chunk for rank j; returns (n, ...) with out[j] the chunk
        received FROM rank j (``all_to_all_single``'s layout). Stage σ ships
        x[σ(r)] to σ(r), which files it under σ⁻¹(σ(r)) = r."""
        program = _opt.as_program(program)
        _check_kind(program, "alltoall")
        if x.shape[0] != program.n:
            raise ValueError(f"leading dim {x.shape[0]} != group size {program.n}")
        r = self._rank(group, program, x)
        if self.overlap_fused:
            order = [st for w in _wave_stages(program) for st in w]
            sig = np.stack([st.sigma_np for st in order])
            inv = np.stack([st.inverse_np for st in order])
            all_sel = x[torch.from_numpy(sig[:, r]).long().to(x.device)]  # ONE gather
            recvs, pending, k = [], [], 0
            for wave in _wave_stages(program):
                issued = []
                for st in wave:
                    issued.append(_issue(all_sel[k], st.pairs, group, r, k))
                    k += 1
                for works, _ in pending:  # drain the previous wave
                    _wait(works)
                pending = issued
                recvs.extend(recv for _, recv in issued)
            for works, _ in pending:
                _wait(works)
            # ONE scatter: idle emulated ranks file their zeros at their own row
            return _scatter_rows(torch.zeros_like(x), inv[:, r], torch.stack(recvs))
        out = torch.zeros_like(x)
        for k, op in enumerate(self._ordered(program)):
            assert isinstance(op, Perm)
            out[int(op.inverse_np[r])] = ppermute(x[int(op.sigma_np[r])], op.pairs, group, r, k)
        return out

    def alltoall_compute(self, x: torch.Tensor, group, program, compute=None) -> torch.Tensor:
        """Round trip: ship chunk x[j] to rank j, apply rank j's ``compute``
        there, return the processed chunk to its sender: out[j] =
        compute_j(x[j]), NOT the all-to-all transpose (``compute=None`` is
        the identity round trip). ``compute`` is THIS rank's batched chunk
        transform, called with the (V, ...) stack of one wave's arrivals.

        Waves follow the program's ``start_step`` stamps (§3 Schedules
        1–3): wave w's exchanges are issued BEFORE wave w-1's arrivals are
        computed on and sent back over the inverse pairs; the pending list
        holds exactly one wave of arrivals between issue and drain. Barrier
        programs are a single wave."""
        program = _opt.as_program(program)
        _check_kind(program, "alltoall")
        if x.shape[0] != program.n:
            raise ValueError(f"leading dim {x.shape[0]} != group size {program.n}")
        r = self._rank(group, program, x)
        waves = _wave_stages(program)
        order = [st for w in waves for st in w]
        dests = np.stack([st.sigma_np for st in order])[:, r]
        all_sel = x[torch.from_numpy(dests).long().to(x.device)]
        backs: list = [None] * len(order)

        def drain(pending):
            if not pending:
                return
            for works, _, _ in pending:
                _wait(works)
            stacked = torch.stack([recv for _, _, recv in pending])
            ys = stacked if compute is None else compute(stacked)
            returns = []
            for j, (_, k, _) in enumerate(pending):
                inv_pairs = tuple((d, s) for s, d in order[k].pairs)
                returns.append((k, _issue(ys[j], inv_pairs, group, r, len(order) + k)))
            for k, (works, recv) in returns:
                _wait(works)
                backs[k] = recv

        pending, k = [], 0
        for wave in waves:
            newly = []
            for st in wave:
                works, recv = _issue(all_sel[k], st.pairs, group, r, k)
                newly.append((works, k, recv))
                k += 1
            drain(pending)
            pending = newly
        drain(pending)
        # Idle emulated ranks: dests == r and every back is zeros
        return _scatter_rows(torch.zeros_like(x), dests, torch.stack(backs))

    def allreduce(self, x: torch.Tensor, group, program) -> torch.Tensor:
        """Recursive-doubling all-reduce (sum): one pairwise exchange per
        cube dimension, the §4 ascend algorithm on the emulated
        hypercube."""
        program = _opt.as_program(program)
        _check_kind(program, "allreduce")
        r = self._rank(group, program, x)
        for k, st in enumerate(self._ordered(program)):
            assert isinstance(st, ReduceCombine)
            recv = ppermute(x, st.link_pairs, group, r, k)
            if st.self_mask_np.any():  # local contributions (identity pairs)
                recv = recv + (x if st.self_mask_np[r] else torch.zeros_like(x))
            x = x + recv
        return x

    def broadcast(self, x: torch.Tensor, group, program, *, pipelined: bool = False) -> torch.Tensor:
        """Spanning-tree broadcast from ``program.root``: each stage is a
        masked partial exchange; non-receivers keep their value. Multi-round
        (pipelined wave) programs take ``x`` with a leading wave dim
        (num_rounds, ...); wave w's tree moves slice x[w]. ``pipelined=True``
        (or ``overlap`` on the backend) replays in start_step order."""
        program = _opt.as_program(program)
        _check_kind(program, "broadcast")
        r = self._rank(group, program, x)
        waves = program.num_rounds > 1
        val, k = x, 0
        for group_ in program.step_groups(pipelined=pipelined or self.overlap):
            pre = val
            for st in group_:
                assert isinstance(st, Match)
                sent = pre[st.round_index] if waves else pre
                recv = ppermute(sent, st.pairs, group, r, k)
                k += 1
                if not st.dst_mask_np[r]:
                    continue
                if waves:
                    val = val.clone()
                    val[st.round_index] = recv
                else:
                    val = recv
        return val

    def matmul(self, b: torch.Tensor, a: torch.Tensor, group, program) -> torch.Tensor:
        """§2 block product: ``b``/``a`` are this rank's (X, X) blocks of B
        and A in the paper's storage map; returns its (X, X) block of B @ A.
        Per-rank state is (val, acc), driven by the program's LocalContract
        stages; every hop is one exchange, with no all-gather."""
        program = _opt.as_program(program)
        _check_kind(program, "matmul")
        r = self._rank(group, program, b, a)
        dtype = torch.result_type(b, a)
        val = torch.zeros(b.shape, dtype=dtype, device=b.device)
        acc = torch.zeros_like(val)
        c = torch.zeros_like(val)
        k = 0
        for group_ in program.step_groups(pipelined=self.overlap):
            if isinstance(group_[0], LocalContract):
                (st,) = group_
                if st.fn == "load_b":
                    val, acc = b.to(dtype), torch.zeros_like(acc)
                elif st.fn == "mul_a":
                    val = val @ a.to(dtype)  # the off-network block product
                    acc = torch.zeros_like(acc)
                elif st.fn == "promote":
                    val, acc = acc, torch.zeros_like(acc)
                elif st.fn == "store_c" and st.mask_np[r]:
                    c = val
                continue
            pre = val
            for st in group_:
                if isinstance(st, Match):
                    recv = ppermute(pre, st.pairs, group, r, k)
                    if st.dst_mask_np[r]:
                        val = recv
                elif isinstance(st, ReduceCombine):
                    recv = ppermute(pre, st.link_pairs, group, r, k)
                    if st.self_mask_np.any():
                        recv = recv + (pre if st.self_mask_np[r] else torch.zeros_like(pre))
                    acc = acc + recv
                else:  # pragma: no cover - lowering never emits Perm here
                    raise TypeError(f"unexpected stage {st!r} in matmul program")
                k += 1
        return c

    # ------------------------------------------------- whole-array wrappers
    def _gather(self, local: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
        check_transport(local, group)
        local = local.contiguous()
        outs = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
        dist.all_gather(outs, local, group=group)
        return torch.stack(outs, dim=dim)

    def run_alltoall(self, x_global, program, group=None) -> torch.Tensor:
        """x_global: (n, n, ...) where x_global[i, j] is the chunk rank i
        sends to rank j; returns (n, n, ...) with out[i, j] = x_global[j, i]
        moved by the paper's round schedule, on every rank. An
        ``OptimizedProgram`` takes the fused table replay on the global
        array: wave by wave (``optimize.torch_alltoall_overlapped``) with
        ``overlap_fused``, else in one scatter; both give the same bits."""
        x = torch.as_tensor(x_global)
        if isinstance(program, _opt.OptimizedProgram):
            _check_kind(program.program, "alltoall")
            if self.overlap_fused:
                return _opt.torch_alltoall_overlapped(program, x.device)(x)
            return _opt.torch_alltoall(program, x.device)(x)
        r = dist.get_rank(group)
        return self._gather(self.alltoall(x[r], group, program), group)

    def run_alltoall_compute(self, x_global, program, compute=None, weights=(),
                             group=None) -> torch.Tensor:
        """x_global: (n, n, ...) with x_global[i, j] the chunk rank i sends
        to rank j; returns out[i, j] = compute_j(x_global[i, j]) on every
        rank. ``compute(chunks, *wl)`` runs on each rank with one wave's
        (V, ...) arrivals and ``wl``, that rank's row of every array in
        ``weights`` (each (n, ...))."""
        prog = _opt.as_program(program)
        _check_kind(prog, "alltoall")
        x = torch.as_tensor(x_global)
        r = dist.get_rank(group)
        wl = [torch.as_tensor(w)[r] for w in weights]
        fn = None if compute is None else (lambda chunks: compute(chunks, *wl))
        return self._gather(self.alltoall_compute(x[r], group, prog, fn), group)

    def run_allreduce(self, x_global, program, group=None) -> torch.Tensor:
        x = torch.as_tensor(x_global)
        if isinstance(program, _opt.OptimizedProgram):
            _check_kind(program.program, "allreduce")
            return _opt.torch_allreduce(program, x.device)(x)
        r = dist.get_rank(group)
        return self._gather(self.allreduce(x[r], group, program), group)

    def run_broadcast(self, x_global, program, group=None, *, pipelined: bool = False
                      ) -> torch.Tensor:
        """Single round: x (n, ...). Pipelined waves: x (R, n, ...) with the
        rank axis second. Optimized programs replay their fused tables on
        the global array, in barrier order, which gives the same bits."""
        x = torch.as_tensor(x_global)
        if isinstance(program, _opt.OptimizedProgram):
            _check_kind(program.program, "broadcast")
            return _opt.torch_broadcast(program, x.device)(x)
        waves = _opt.as_program(program).num_rounds > 1
        r = dist.get_rank(group)
        local = self.broadcast(x[:, r] if waves else x[r], group, program, pipelined=pipelined)
        return self._gather(local, group, dim=1 if waves else 0)

    def run_matmul(self, B, A, program, group=None) -> torch.Tensor:
        """B, A: (N·X, N·X) matrices -> B @ A via the §2 rounds on a group of
        ``program.n`` ranks in router order. Emulated programs scatter the
        guest's blocks to their ``active_devices`` slots of the host group
        (grid metadata is the GUEST grid) and gather them back."""
        prog = _opt.as_program(program)
        _check_kind(prog, "matmul")
        if prog.grid is None:
            raise ValueError("matmul program lacks grid metadata")
        B, A = torch.as_tensor(B), torch.as_tensor(A)
        b = _opt.torch_scatter_guest(_opt.torch_scatter_blocks(B, prog.grid), prog)
        a = _opt.torch_scatter_guest(_opt.torch_scatter_blocks(A, prog.grid), prog)
        if isinstance(program, _opt.OptimizedProgram):
            c = _opt.torch_matmul_blocks(program, B.device)(b, a)
        else:
            r = dist.get_rank(group)
            c = self._gather(self.matmul(b[r], a[r], group, prog), group)
        return _opt.torch_gather_blocks(_opt.torch_gather_guest(c, prog), prog.grid)


@functools.lru_cache(maxsize=None)
def _wave_stages(program: CollectiveProgram) -> tuple[tuple[Perm, ...], ...]:
    """Stages grouped by launch wave — one tuple per distinct ``start_step``
    value, waves in launch order, stage order preserved inside a wave.
    Barrier (unstamped) programs collapse to a single wave."""
    waves: dict[int, list[Perm]] = {}
    for st in program.pipelined_stages():
        assert isinstance(st, Perm)
        waves.setdefault(st.start_step, []).append(st)
    return tuple(tuple(waves[s]) for s in sorted(waves))
