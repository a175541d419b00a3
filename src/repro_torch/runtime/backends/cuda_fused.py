"""CUDA-fused backend: fused table replay with hand-written CUDA kernels on
the reduce and contraction hot spots.

Replays the OPTIMIZED form of a program (``runtime.optimize``) on torch
tensors and pushes the compute into kernels of ``repro_torch/csrc``:

  * ``run_allreduce`` — every §4 round in ONE launch of the reduce-rounds
    kernel (``reduce_rounds``): each block keeps (n, block_f) column tiles
    of the buffer on chip across all rounds, driven by the stacked
    (gather, mask) tables, packed once per program (``pack_tables``);
  * ``run_matmul`` — the §2 replay with its combine groups on the same
    kernel at R = 1 with the add into the accumulator in its epilogue
    (``combine_rows(..., acc=)``) and its ``mul_a`` contraction on the
    batched block-product kernel (``kernels/block_matmul``).

The reduce kernel has two bodies, chosen by dtype and shape (``body_for``):
``staged`` (a bulk-copy ring into shared memory, the tables held there)
where rows are whole 16-byte vectors and the tiles fit, ``slab`` otherwise.

``run_alltoall`` and ``run_broadcast`` are pure data movement with no
compute to fuse: they are the optimizer's torch table replays (one batched
scatter; one masked gather per group).

``allreduce_shard`` is the per-shard §4 all-reduce: called on every rank of
a process group with that rank's buffer, it runs each round's exchange as
K5 (``csrc/ring_exchange.cu``): a put into the partner's window mapped
through CUDA IPC and a signal, then the wait, which spins for the flag
and adds; where ranks share a card, a stream sync and a group barrier
come before the wait. Its plain version,
``allreduce_shard_plain``, exchanges through the group's transport
(``ring_exchange_plain``, one ``batch_isend_irecv`` pair per round).

``CudaFusedBackend()`` runs on the card and raises where there is none;
``CudaFusedBackend(device="cpu")`` runs the same replay with every kernel's
plain torch version, which is how the tests reach it. Inputs may be numpy
arrays or tensors; results are tensors on the backend's device, in the
input's dtype.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import build
from repro_torch.kernels.block_matmul.ops import batched_matmul
from repro_torch.runtime import optimize as _opt
from repro_torch.runtime.backends.torch_dist import check_transport, global_rank
from repro_torch.runtime.program import check_kind as _check_kind


# ---------------------------------------------------------------------------
# Kernels: the reduce rounds (csrc/reduce_rounds.cu) and their plain versions.
# ---------------------------------------------------------------------------

#: The reduce kernel's plain version at R rounds is the optimizer's torch replay.
_reduce_rounds_plain = _opt.replay_allreduce


def _combine_rows_plain(flat: torch.Tensor, gather: torch.Tensor, mask: torch.Tensor,
                        acc: torch.Tensor | None = None) -> torch.Tensor:
    fold = _opt.combine_fold(torch.zeros_like(flat), flat, gather, mask)
    return fold if acc is None else acc + fold


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The reduce kernel's bodies (csrc/reduce_rounds.cu), chosen by ``body_for``.
BODIES = ("slab", "staged")
#: The staged body's limits (``staged::`` in csrc/reduce_rounds.cu, which
#: also reports them through ``reduce_rounds_staged_limits``): bytes of
#: values a column tile holds (its consumers' registers), stages in its
#: ring, rows and columns of a TMA box, and the shared memory a block may
#: take with two blocks on an H100 SM (228 KiB / 2 less 1 KiB reserved).
STAGED_TILE_BYTES = 16384
STAGED_MAX_STAGES = 4
STAGED_BOX = 256
STAGED_SMEM_BYTES = 115712


@functools.lru_cache(maxsize=None)
def _slab_floats() -> int:
    return build.load("reduce_rounds").reduce_rounds_slab_floats()


def column_shift(n: int, features: int, slab_floats: int) -> int:
    """log2 of the slab body's column tile ``block_f``: the widest power of
    two whose (n, block_f) slab fits ``slab_floats``, and no wider than
    the buffer needs."""
    if n > slab_floats:
        raise ValueError(f"n={n} rows exceed the {slab_floats}-float slab")
    shift = 0
    while (n << (shift + 1)) <= slab_floats and (1 << shift) < features:
        shift += 1
    return shift


def staged_smem(n: int, shift: int, esize: int, rounds: int, k_rows: int, stages: int,
                acc: bool) -> int:
    """Bytes of shared memory the staged body takes: barriers, a row of
    zeros and the packed table, ``stages`` stages of an (n, 1 << shift)
    tile (two tiles each with ``acc``) and, for R > 1, two scratch tiles.
    A tile's rows come in TMA boxes of one height, at most STAGED_BOX and,
    for more than one box, a multiple of 8 rows (each box lands 128-byte
    aligned), so the last box may pad it; the header and each tile end on
    a 128-byte boundary."""
    def up(b, to=128):
        return -(-b // to) * to

    boxes = -(-n // STAGED_BOX)
    rows = n if boxes == 1 else boxes * up(-(-n // boxes), 8)
    tile = up((rows << shift) * esize)
    header = up(2 * STAGED_MAX_STAGES * 8 + (esize << shift) + 4 * rounds * k_rows * n)
    return header + stages * tile * (2 if acc else 1) + (2 * tile if rounds > 1 else 0)


@functools.lru_cache(maxsize=1024)
def stage_tile(n: int, features: int, esize: int, rounds: int, k_rows: int, acc: bool = False,
               smem: int = STAGED_SMEM_BYTES) -> tuple[int, int] | None:
    """The staged body's column tile and ring, ``(shift, stages)`` with
    ``block_f = 1 << shift``, or None where it does not take the shape. A
    row of ``features`` elements of ``esize`` bytes must be whole 16-byte
    vectors, and the tile at least one vector wide. The widest power of two
    up to a TMA box (STAGED_BOX columns) whose (n, block_f) tile holds at
    most STAGED_TILE_BYTES of values and no wider than the buffer needs;
    then as many stages as fit ``smem`` beside the tables and scratch, at
    most STAGED_MAX_STAGES. Fewer than two stages halve the tile, down to
    one vector. Columns are TMA coordinates, so ``features < 2**31``."""
    vec = 16 // esize
    if n < 1 or not 0 < features < 2**31 or (features * esize) % 16 or n * 16 > STAGED_TILE_BYTES:
        return None
    shift = vec.bit_length() - 1
    while ((n << (shift + 1)) * esize <= STAGED_TILE_BYTES and 2 << shift <= STAGED_BOX
           and (1 << shift) < features):
        shift += 1
    while True:
        fixed = staged_smem(n, shift, esize, rounds, k_rows, 0, acc)
        per_stage = staged_smem(n, shift, esize, rounds, k_rows, 1, acc) - fixed
        stages = min(STAGED_MAX_STAGES, (smem - fixed) // per_stage) if smem > fixed else 0
        if stages >= 2:
            return shift, stages
        if 1 << shift == vec:
            return None
        shift -= 1


def body_for(dtype: torch.dtype, n: int, features: int, rounds: int, k_rows: int,
             acc: bool = False, aligned: bool = True) -> str:
    """The body the reduce kernel runs for these operands: ``"staged"``
    where ``stage_tile`` takes the shape and every base (x, out, acc) is
    16-byte aligned (``aligned``), else ``"slab"``."""
    if aligned and stage_tile(n, features, dtype.itemsize, rounds, k_rows, acc) is not None:
        return "staged"
    return "slab"


def pack_tables(gather, mask):
    """The staged body's table: each (gather, mask) entry as one int32, the
    gathered row where the mask holds and -1 where it does not. numpy
    arrays or tensors, of any shape."""
    if isinstance(gather, torch.Tensor):
        return torch.where(mask, gather, -1).to(torch.int32).contiguous()
    return np.where(mask, gather, -1).astype(np.int32)


def replay_packed(flat: torch.Tensor, packed: torch.Tensor, *, self_add: bool = True,
                  acc: torch.Tensor | None = None) -> torch.Tensor:
    """What the staged body computes from packed (R, k, n) tables, in plain
    torch on (n, F) values: per round ``recv`` folds ``where(p >= 0,
    val[p], 0)`` for k in order from zeros, then ``val = val + recv`` (or
    ``recv`` without the self-add); ``acc + val`` at the end where ``acc``
    is given. The same bits as the unpacked replays."""
    zero = flat.new_zeros(())
    val = flat
    for r in range(packed.shape[0]):
        recv = torch.zeros_like(val)
        for p in packed[r]:
            recv = recv + torch.where((p >= 0)[:, None], val[p.clamp(min=0).long()], zero)
        val = val + recv if self_add else recv
    return val if acc is None else acc + val


def _launch_rounds(flat, gather, mask, *, packed, acc, self_add: bool, body, what: str):
    """Check the operands, choose the body and launch it; returns the output
    and the body launched (None where the output is empty)."""
    tensors = [flat, gather, mask] + [t for t in (packed, acc) if t is not None]
    if flat.device.type != "cuda" or any(t.device != flat.device for t in tensors):
        raise ValueError(f"{what} takes CPU or same-card CUDA tensors, got "
                         f"{[str(t.device) for t in tensors]}")
    if flat.dtype not in _DTYPES:
        raise TypeError(f"{what} takes float32 or bfloat16 on the card, got {flat.dtype}")
    if gather.dtype != torch.int32 or mask.dtype != torch.bool:
        raise TypeError(f"{what} takes int32 gather and bool mask tables, got "
                        f"{gather.dtype} and {mask.dtype}")
    if (flat.dim() != 2 or gather.dim() != 3 or mask.shape != gather.shape
            or gather.shape[2] != flat.shape[0]):
        raise ValueError(f"{what}: expected (n, F) values and (R, k, n) tables, got "
                         f"{tuple(flat.shape)}, {tuple(gather.shape)}, {tuple(mask.shape)}")
    if packed is not None and (packed.dtype != torch.int32 or packed.shape != gather.shape):
        raise ValueError(f"{what}: the packed table must be int32 of the tables' shape, got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    if acc is not None and (acc.dtype != flat.dtype or acc.shape != flat.shape):
        raise ValueError(f"{what}: acc must match the values, got {acc.dtype} "
                         f"{tuple(acc.shape)} for {flat.dtype} {tuple(flat.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} takes contiguous values and tables")
    if body not in (None,) + BODIES:
        raise ValueError(f"{what}: no body {body!r}; the bodies are {BODIES}")
    n, features = flat.shape
    rounds, k_rows, _ = gather.shape
    if rounds == 0 or k_rows == 0:
        raise ValueError(f"{what} takes at least one round and one table row, got "
                         f"(R, k) = ({rounds}, {k_rows})")
    out = torch.empty_like(flat)
    if out.numel() == 0:
        return out, None
    aligned = all(t.data_ptr() % 16 == 0 for t in (flat, out, acc) if t is not None)
    chosen = body_for(flat.dtype, n, features, rounds, k_rows, acc is not None, aligned)
    if body == "staged" and chosen != "staged":
        raise ValueError(f"{what}: the staged body does not take {flat.dtype} "
                         f"{tuple(flat.shape)} with (R, k) = ({rounds}, {k_rows})"
                         f"{'' if aligned else ' at bases off 16 bytes'}")
    body = body or chosen
    lib = build.load("reduce_rounds")
    acc_ptr = None if acc is None else acc.data_ptr()
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    with torch.cuda.device(flat.device):
        if body == "staged":
            shift, stages = stage_tile(n, features, flat.element_size(), rounds, k_rows,
                                       acc is not None)
            if packed is None:
                packed = pack_tables(gather, mask)
            err = lib.reduce_rounds_staged_launch(
                flat.data_ptr(), acc_ptr, out.data_ptr(), packed.data_ptr(), rounds, k_rows,
                n, features, shift, stages, int(self_add), _DTYPES[flat.dtype], stream)
        else:
            err = lib.reduce_rounds_launch(
                flat.data_ptr(), acc_ptr, out.data_ptr(), gather.data_ptr(), mask.data_ptr(),
                rounds, k_rows, n, features, column_shift(n, features, _slab_floats()),
                int(self_add), _DTYPES[flat.dtype], stream)
    build.check(err, f"{what} launch ({body} body)")
    return out, body


def reduce_rounds(flat: torch.Tensor, gather: torch.Tensor, mask: torch.Tensor, *,
                  packed: torch.Tensor | None = None, body: str | None = None) -> torch.Tensor:
    """K1, the §4 all-reduce replay in one launch: for each of R rounds,
    ``val += Σ_k where(mask[r, k], val[gather[r, k]], 0)`` folded in k
    order. ``flat`` is (n, F) float32 or bfloat16 (each bf16 add is rounded
    at once, as a torch bf16 add is); the tables are (R, k, n) int32 / bool
    (``optimize.stacked_combine_tables``), gathers in [0, n) as ``optimize``
    builds them (the kernel does not check). Bit-exact with the plain
    version.

    On the card the body follows ``body_for`` (``body`` forces one; a
    forced ``"staged"`` that the operands do not fit raises). ``packed``
    is ``pack_tables(gather, mask)`` where the caller keeps it, else the
    staged body packs them on the card. Every launch adds one to
    ``reduce_rounds.launches`` and to its body's entry of
    ``reduce_rounds.body_launches``."""
    if flat.device.type == "cpu":
        return _reduce_rounds_plain(flat, gather, mask)
    out, launched = _launch_rounds(flat, gather, mask, packed=packed, acc=None, self_add=True,
                                   body=body, what="reduce_rounds")
    if launched:
        reduce_rounds.launches += 1
        reduce_rounds.body_launches[launched] += 1
    return out


def combine_rows(flat: torch.Tensor, gather: torch.Tensor, mask: torch.Tensor, *,
                 acc: torch.Tensor | None = None, packed: torch.Tensor | None = None,
                 body: str | None = None) -> torch.Tensor:
    """K2, one §2 ReduceCombine group: ``Σ_k where(mask[k], val[gather[k]], 0)``
    in stage order over (n, F) rows, with (k, n) tables; with ``acc`` (n, F)
    of the same dtype, ``acc + that``, added in the kernel's epilogue (the
    bits of the plain ``acc + fold``). The reduce-rounds kernel at R = 1
    without the self-add; ``packed`` and ``body`` as for ``reduce_rounds``.
    Every launch adds one to ``combine_rows.launches``, to its body's entry
    of ``combine_rows.body_launches`` and, with ``acc``, to
    ``combine_rows.acc_launches``."""
    if acc is not None and acc.shape != flat.shape:
        raise ValueError(f"combine_rows: acc {tuple(acc.shape)} for values {tuple(flat.shape)}")
    if flat.device.type == "cpu":
        return _combine_rows_plain(flat, gather, mask, acc)
    out, launched = _launch_rounds(flat, gather[None], mask[None],
                                   packed=None if packed is None else packed[None], acc=acc,
                                   self_add=False, body=body, what="combine_rows")
    if launched:
        combine_rows.launches += 1
        combine_rows.body_launches[launched] += 1
        combine_rows.acc_launches += acc is not None
    return out


reduce_rounds.launches = combine_rows.launches = combine_rows.acc_launches = 0
reduce_rounds.body_launches = dict.fromkeys(BODIES, 0)
combine_rows.body_launches = dict.fromkeys(BODIES, 0)


@functools.lru_cache(maxsize=None)
def _matmul_executor(opt: _opt.OptimizedProgram, device: torch.device):
    """The §2 replay with K3 as its product and K2 as its combine hook. Each
    combine group's packed table is made on the host once, beside its
    gather and mask, and found by its gather tensor, which the recipe holds."""
    recipe = tuple(
        (kind, fn, _opt.to_device_tables(
            {**tabs, "packed": pack_tables(tabs["gather"], tabs["mask"])}
            if kind == "combine" else tabs, device))
        for kind, fn, tabs in _opt.matmul_tables(opt))
    packed = {id(t["gather"]): t["packed"] for kind, _, t in recipe if kind == "combine"}

    def combine_fn(acc, val, gather, mask):
        """``acc + combine_rows(val)``, the add in K2's epilogue."""
        n = val.shape[0]
        return combine_rows(val.reshape(n, -1), gather, mask, acc=acc.reshape(n, -1),
                            packed=packed[id(gather)]).reshape(val.shape)

    return functools.partial(_opt.replay_matmul, recipe, mul_fn=batched_matmul,
                             combine_fn=combine_fn)


@functools.lru_cache(maxsize=None)
def _allreduce_tables(opt: _opt.OptimizedProgram, device: torch.device):
    tables = _opt.allreduce_tables(opt)
    return _opt.to_device_tables(
        {**tables, "packed": pack_tables(tables["gather"], tables["mask"])}, device)


# ---------------------------------------------------------------------------
# K5: the per-shard exchange (csrc/ring_exchange.cu) and its plain version.
# ---------------------------------------------------------------------------

#: Seconds a K5 kernel spins for its partner's flag before the call raises.
RING_TIMEOUT_S = 60.0


@functools.lru_cache(maxsize=None)
def ring_partners(program) -> tuple[np.ndarray, ...]:
    """Each §4 round's partner table (``inverse_np``), cached per program.
    K5 takes native rounds only: full permutations that are involutions,
    so the partner a rank puts to is the one that puts to it."""
    out = []
    for st in program.comm_stages:
        if not (st.is_full_permutation
                and np.array_equal(st.inverse_np[st.inverse_np], np.arange(program.n))):
            raise ValueError(
                "the K5 ring path handles native (full-involution) programs; "
                "replay emulated programs via run_allreduce or torch_dist")
        out.append(st.inverse_np)
    return tuple(out)


def ring_exchange_plain(x: torch.Tensor, partner: int, group) -> torch.Tensor:
    """K5's plain version: send ``x`` to rank ``partner`` of ``group`` and
    receive the partner's buffer, one ``batch_isend_irecv`` pair through
    the group's transport (which must carry ``x``: gloo carries CPU
    tensors). Returns the arrival."""
    check_transport(x, group)
    recv = torch.empty_like(x)
    peer = global_rank(group, partner)
    for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, x.contiguous(), peer, group),
                                        dist.P2POp(dist.irecv, recv, peer, group)]):
        work.wait()
    return recv


class RingWindow:
    """K5's receive window on this rank for one (group, card, program): the
    library's cudaMalloc'd control area and one slot of ``slot_bytes`` per
    round, its IPC handle all-gathered over the group and every peer's
    window opened. A collective: every rank of the group creates its window
    together. ``epoch`` counts the calls made through it; ``shared`` says
    whether two ranks of the group share a card (the same on every rank)."""

    def __init__(self, group, slot_bytes: int, rounds: int, device: torch.device):
        lib = build.load("ring_exchange")
        self.group, self.device = group, device
        self.rank, self.n = dist.get_rank(group), dist.get_world_size(group)
        self.slot_bytes, self.rounds = slot_bytes, rounds
        self.epoch = 0
        handle = ctypes.create_string_buffer(lib.ring_handle_bytes())
        ptr = ctypes.c_void_p()
        with torch.cuda.device(device):
            build.check(lib.ring_window_create(slot_bytes, rounds, ctypes.byref(ptr), handle),
                        "ring_exchange window")
        self.ptr = ptr
        peers = [None] * self.n
        dist.all_gather_object(peers, (handle.raw, str(torch.cuda.get_device_properties(
            device).uuid)), group=group)
        self.shared = len({card for _, card in peers}) < self.n
        with torch.cuda.device(device):
            build.check(lib.ring_window_open(ptr, self.rank, self.n,
                                             b"".join(h for h, _ in peers)),
                        "ring_exchange window open")

    def check(self) -> None:
        """Wait for this rank's stream and raise if a kernel found no flag
        of this call in time."""
        code = ctypes.c_int(0)
        with torch.cuda.device(self.device):
            build.check(build.load("ring_exchange").ring_error(
                self.ptr, torch.cuda.current_stream().cuda_stream, ctypes.byref(code)),
                "ring_exchange")
        if code.value:
            kind, round_ = code.value >> 8, code.value & 0xFF
            what = {1: "the put's partner never consumed the previous call's slot",
                    2: "the wait found no flag of this call from its partner",
                    3: "the wait read a flag from a later call"}.get(kind, f"error {kind}")
            raise RuntimeError(f"K5 on rank {self.rank}, round {round_} of call {self.epoch}: "
                               f"{what}")

    def close(self) -> None:
        with torch.cuda.device(self.device):
            build.check(build.load("ring_exchange").ring_window_close(self.ptr),
                        "ring_exchange window close")


_ring_windows: dict = {}


def _close_windows(group, keys) -> None:
    """Free the windows under ``keys`` on every rank of ``group``: a
    collective. Each rank drains its stream first and a barrier on each
    side keeps a window mapped until no peer can still touch it."""
    torch.cuda.synchronize()
    dist.barrier(group=group)
    for key in keys:
        _ring_windows.pop(key).close()
    dist.barrier(group=group)


def ring_window(group, x: torch.Tensor, program) -> RingWindow:
    """The K5 window of ``program`` on ``group`` and ``x``'s card, created
    on first use (a collective) and kept until ``close_ring_windows``. Its
    slots fit the largest buffer seen: a smaller buffer reuses them, a
    larger one replaces the window (a collective too)."""
    key = (group, x.device, program)
    nbytes = x.numel() * x.element_size()
    window = _ring_windows.get(key)
    if window is not None and window.slot_bytes < nbytes:
        _close_windows(group, [key])
        window = None
    if window is None:
        window = _ring_windows[key] = RingWindow(group, nbytes, len(program.comm_stages),
                                                 x.device)
    return window


def close_ring_windows(group) -> None:
    """Free every K5 window of ``group`` on every rank: a collective."""
    _close_windows(group, [key for key in _ring_windows if key[0] is group])


def _ring_args(x: torch.Tensor, window: RingWindow, round_: int, partner: int):
    nbytes = x.numel() * x.element_size()
    if x.device != window.device or nbytes > window.slot_bytes:
        raise ValueError(f"ring_exchange: the window holds {window.slot_bytes} bytes a slot on "
                         f"{window.device}, got {nbytes} on {x.device}")
    if not 0 <= round_ < window.rounds or not 0 <= partner < window.n:
        raise ValueError(f"ring_exchange: round {round_} of {window.rounds}, "
                         f"partner {partner} of {window.n}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()  # the kernels move 16 bytes per access
    return x, torch.cuda.current_stream(x.device).cuda_stream


def ring_put(x: torch.Tensor, window: RingWindow, round_: int, partner: int) -> None:
    """K5's put: copy ``x`` into slot ``round_`` of rank ``partner``'s
    window once the partner has consumed the previous call's (spinning up
    to ``RING_TIMEOUT_S``). Every launch adds one to ``ring_put.launches``."""
    x, stream = _ring_args(x, window, round_, partner)
    with torch.cuda.device(x.device):
        err = build.load("ring_exchange").ring_put(
            window.ptr, round_, partner, x.data_ptr(), x.numel() * x.element_size(),
            window.epoch, int(RING_TIMEOUT_S * 1e9), stream)
    build.check(err, "ring_put launch")
    ring_put.launches += 1


def ring_signal(window: RingWindow, round_: int, partner: int) -> None:
    """K5's signal: release this call's flag of round ``round_`` into rank
    ``partner``'s window, after the put. Adds one to ``ring_signal.launches``."""
    with torch.cuda.device(window.device):
        err = build.load("ring_exchange").ring_signal(
            window.ptr, round_, partner, window.epoch,
            torch.cuda.current_stream(window.device).cuda_stream)
    build.check(err, "ring_signal launch")
    ring_signal.launches += 1


def ring_wait_add(x: torch.Tensor, window: RingWindow, round_: int, partner: int
                  ) -> torch.Tensor:
    """K5's wait: spin (up to ``RING_TIMEOUT_S``) until this call's put of
    round ``round_`` has arrived, then return ``x + recv`` and acknowledge
    the slot to ``partner``. After ``ring_exchange``'s barrier (ranks that
    share a card) the flag is already set and the first read ends the
    spin. Adds one to
    ``ring_wait_add.launches``."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"ring_wait_add takes float32 or bfloat16, got {x.dtype}")
    x, stream = _ring_args(x, window, round_, partner)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = build.load("ring_exchange").ring_wait_add(
            window.ptr, round_, partner, x.data_ptr(), out.data_ptr(), x.numel(),
            _DTYPES[x.dtype], window.epoch, int(RING_TIMEOUT_S * 1e9), stream)
    build.check(err, "ring_wait_add launch")
    ring_wait_add.launches += 1
    return out


ring_put.launches = ring_signal.launches = ring_wait_add.launches = 0


def ring_exchange(x: torch.Tensor, window: RingWindow, round_: int, partner: int
                  ) -> torch.Tensor:
    """K5, one §4 round on the card: put, signal, then the wait; returns
    ``x + recv`` with recv the partner's ``x``, the bits of
    ``x + ring_exchange_plain(x)``. Where ranks of the group share a card
    (``window.shared``) this rank's stream sync and a barrier of the group
    come between signal and wait, which then finds its flag set: their
    contexts are time-sliced without MPS, and a wait that spins holds the
    card its partner needs to put. Where every rank has a card of its own,
    the wait spins for its flag."""
    ring_put(x, window, round_, partner)
    ring_signal(window, round_, partner)
    if window.shared:
        torch.cuda.current_stream(x.device).synchronize()
        dist.barrier(group=window.group)
    return ring_wait_add(x, window, round_, partner)


def allreduce_shard_plain(x: torch.Tensor, group, program) -> torch.Tensor:
    """The per-shard §4 all-reduce with K5's plain version in the round
    loop: ``x = x + ring_exchange_plain(x, partner)`` per round."""
    prog = _opt.as_program(program)
    _check_kind(prog, "allreduce")
    rank = dist.get_rank(group)
    for partners in ring_partners(prog):
        x = x + ring_exchange_plain(x, int(partners[rank]), group)
    return x


# ---------------------------------------------------------------------------
# The backend.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CudaFusedBackend:
    """Fused table replay + CUDA kernels on the reduce/contract hot path.

    ``device`` defaults to the card and raises without one; ``"cpu"`` runs
    every kernel's plain torch version instead."""

    device: torch.device | str = "cuda"
    name: str = "cuda_fused"

    def __post_init__(self):
        device = torch.device(self.device)
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"cuda_fused runs on 'cuda' or 'cpu', not {device}")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("cuda_fused needs a CUDA card and found none; "
                               "pass device='cpu' for the plain torch path")
        object.__setattr__(self, "device", device)

    def _optimized(self, program, kind: str) -> _opt.OptimizedProgram:
        _check_kind(_opt.as_program(program), kind)
        return program if isinstance(program, _opt.OptimizedProgram) \
            else _opt.optimize(program)

    def _tensor(self, x, n: int, what: str) -> torch.Tensor:
        x = torch.as_tensor(x, device=self.device)
        if x.shape[0] != n:
            raise ValueError(f"{what}: expected leading dim {n}, got {tuple(x.shape)}")
        return x

    # ------------------------------------------------------------- contract
    def run_alltoall(self, x, program) -> torch.Tensor:
        opt = self._optimized(program, "alltoall")
        x = self._tensor(x, opt.n, "run_alltoall")
        return _opt.torch_alltoall(opt, self.device)(x)

    def run_allreduce(self, x, program) -> torch.Tensor:
        opt = self._optimized(program, "allreduce")
        x = self._tensor(x, opt.n, "run_allreduce")
        t = _allreduce_tables(opt, self.device)
        flat = x.reshape(opt.n, -1)
        return reduce_rounds(flat, t["gather"], t["mask"], packed=t["packed"]).reshape(x.shape)

    def run_broadcast(self, x, program, *, pipelined: bool = False) -> torch.Tensor:
        # fused replay is order-free: barrier == pipelined bit-for-bit
        opt = self._optimized(program, "broadcast")
        rounds = opt.program.num_rounds
        x = self._tensor(x, rounds if rounds > 1 else opt.n, "run_broadcast")
        return _opt.torch_broadcast(opt, self.device)(x)

    def run_matmul(self, B, A, program) -> torch.Tensor:
        opt = self._optimized(program, "matmul")
        prog = opt.program
        if prog.grid is None:
            raise ValueError("matmul program lacks grid metadata")
        replay = _matmul_executor(opt, self.device)
        b = _opt.torch_scatter_guest(
            _opt.torch_scatter_blocks(torch.as_tensor(B, device=self.device), prog.grid), prog)
        a = _opt.torch_scatter_guest(
            _opt.torch_scatter_blocks(torch.as_tensor(A, device=self.device), prog.grid), prog)
        return _opt.torch_gather_blocks(_opt.torch_gather_guest(replay(b, a), prog),
                                        prog.grid)

    # ------------------------------------------------- per-shard (K5 ring)
    def allreduce_shard(self, x: torch.Tensor, group, program) -> torch.Tensor:
        """Per-shard §4 all-reduce, called on every rank of ``group`` (of
        ``program.n`` ranks) with its own ``x``: one K5 exchange per round,
        ``x = x + recv``. Native programs only, and only on the card: an
        emulated program raises ValueError and a tensor off the card
        RuntimeError (``allreduce_shard_plain`` is the plain version).
        Where ranks share a card, synchronises with the card and the group
        in every round (``ring_exchange``); reads K5's error word at the
        end.

        The first call on a (group, card, program) creates K5's window on
        every rank (``ring_window``): ``program``'s rounds times ``x``'s
        bytes, cudaMalloc'd outside PyTorch's caching allocator, so
        ``torch.cuda.memory_allocated`` does not count it. Later calls
        with a buffer no larger reuse it; ``close_ring_windows(group)``
        frees it."""
        prog = _opt.as_program(program)
        _check_kind(prog, "allreduce")
        partners = ring_partners(prog)
        if x.device.type != "cuda":
            raise RuntimeError(f"allreduce_shard runs K5 on the card and takes CUDA tensors; "
                               f"x lies on {x.device}")
        if dist.get_world_size(group) != prog.n:
            raise ValueError(f"the group has {dist.get_world_size(group)} ranks, "
                             f"the program acts on {prog.n}")
        rank = dist.get_rank(group)
        window = ring_window(group, x, prog)
        window.epoch += 1
        for r, table in enumerate(partners):
            x = ring_exchange(x, window, r, int(table[rank]))
        window.check()
        return x
