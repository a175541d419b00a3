"""Program optimizer — fuse a ``CollectiveProgram`` into batched table ops,
and replay the fused form on torch tensors.

``optimize(program)`` is the performance layer between lowering and
execution. The per-stage replay loop (one permute / one masked select per
stage) is faithful to the paper's round structure but pays a per-stage
cost in dispatch and in per-stage table uploads. The optimizer removes
both without changing a single output bit:

  * **step-group fusion** — every conflict-free step group (the maximal
    stage runs ``CollectiveProgram.step_groups`` yields) collapses into ONE
    batched op: consecutive ``Perm``s become a single stacked-σ scatter
    table (``FusedExchange``), a ``Match`` group becomes one masked-gather
    table (``FusedSelect``), a ``ReduceCombine`` group becomes stacked
    (gather, mask) rows applied in stage order (``FusedCombine``), and
    ``LocalContract`` stages keep their vocabulary (``FusedLocal``);
  * **table stacking** — per-group host arrays are precomputed into
    index tables (stacked along a round axis for the all-reduce), uploaded
    to the device once per (program, device) by ``to_device_tables``;
  * **group-level vectorization** — both the NumPy replay (``np_*``) and
    the torch replay (``torch_*``) apply each fused group as one
    advanced-indexing operation (the §3 all-to-all collapses to a single
    scatter).

What ``optimize()`` preserves:

  * **bit-exactness** — fused replay applies every group against the
    pre-group values with writes landing together, and ``FusedCombine``
    folds rows in stage order, so results are bit-identical to the
    per-stage replay on every backend;
  * **stamps** — the fused ops are built from barrier order
    ``(round_index, step)`` groups; because the schedule verified
    conflict-free under pipelined replay too, the barrier-order fused
    result equals the ``start_step``-ordered replay;
  * **``active_devices``** — emulated (guest-on-host) programs fuse to
    partial tables: idle devices get identity gathers and zero masks, so
    they pass through exactly as the backend contract requires;
  * **conflict-freedom** — fusion only merges stages the lowering already
    proved concurrent; no group ever merges across a synchronous step.

``optimize`` is memoized per program (programs are frozen/hashable); the
torch replay closures are memoized per (optimized program, device), so
repeated collective calls reuse one set of device tables.

The table builders and the ``np_*`` replays are NumPy only; the ``torch_*``
replays run on whatever device their tables were uploaded to. They are the
plain path: the ``cuda_fused`` backend swaps hand-written kernels into the
all-reduce rounds and into the §2 ``mul_a`` / combine hooks of
``build_torch_matmul``.
"""

from __future__ import annotations

import dataclasses
import functools
from collections.abc import Mapping, Sequence

import numpy as np
import torch

from repro_torch.runtime.program import (
    CollectiveProgram,
    LocalContract,
    Match,
    Perm,
    ReduceCombine,
)


# ---------------------------------------------------------------------------
# Fused ops: one per conflict-free step group.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class FusedExchange:
    """All ``Perm`` stages of an all-to-all program as one scatter table:
    ``out[dst[t], src[t]] = x[src[t], dst[t]]`` for every pair t. Valid
    because every stage reads the immutable input and the full exchange
    delivers each ordered (src, dst) chunk exactly once — so the whole
    program is one batched permute, independent of replay order.

    ``starts[t]`` is the pair's pipelined launch stamp (the owning stage's
    ``start_step``, itself the Schedule-1..3 launch from
    ``core.alltoall.round_starts``). Slicing the table by distinct starts
    (``exchange_waves``) recovers the wave-by-wave issue order the
    ``overlap_fused`` replay dispatches — all zeros for barrier schedules,
    where the whole exchange is one wave."""

    src: np.ndarray  # (T,) int32 senders, concatenated over stages
    dst: np.ndarray  # (T,) int32 receivers
    starts: np.ndarray | None = None  # (T,) int32 pipelined launch stamps


@dataclasses.dataclass(frozen=True, eq=False)
class FusedSelect:
    """One ``Match`` step group: ``val = where(mask, val[gather], val)``.
    ``gather`` is identity outside the group's destinations, so idle
    (emulated) devices read themselves and the mask keeps their value."""

    gather: np.ndarray  # (n,) int32
    mask: np.ndarray    # (n,) bool
    wave: int = 0       # broadcast wave (round) the group acts on


@dataclasses.dataclass(frozen=True, eq=False)
class FusedCombine:
    """One ``ReduceCombine`` step group as stacked (gather, mask) rows.
    Row k contributes ``where(mask[k], val[gather[k]], 0)`` and rows fold
    into the accumulator IN ORDER (k-sequential adds), reproducing the
    per-stage accumulation bit-for-bit. Identity (self) pairs become rows
    with identity gathers."""

    gather: np.ndarray  # (k, n) int32
    mask: np.ndarray    # (k, n) bool


@dataclasses.dataclass(frozen=True, eq=False)
class FusedLocal:
    """A ``LocalContract`` stage (matmul state machine step)."""

    fn: str
    mask: np.ndarray | None = None  # (n,) bool for store_c


FusedOp = FusedExchange | FusedSelect | FusedCombine | FusedLocal


@dataclasses.dataclass(frozen=True, eq=False)
class OptimizedProgram:
    """A ``CollectiveProgram`` compiled to fused table ops.

    Carries the source program for metadata (``kind``, ``n``, ``grid``,
    ``root``, ``active_devices``) — backends accept an ``OptimizedProgram``
    anywhere they accept a program and route it to the fused replay.
    ``uniform_rounds`` marks matmul programs whose per-round op recipes are
    identical (always true for the §2 lowering). The torch replay loops
    over the ops either way; the flag is kept so the tables stay
    comparable with the reference package's.
    """

    program: CollectiveProgram
    ops: tuple[FusedOp, ...]
    uniform_rounds: bool = False

    @property
    def kind(self) -> str:
        return self.program.kind

    @property
    def n(self) -> int:
        return self.program.n

    @property
    def num_fused_ops(self) -> int:
        return len(self.ops)


def as_program(program) -> CollectiveProgram:
    """The underlying ``CollectiveProgram`` of either representation."""
    return program.program if isinstance(program, OptimizedProgram) else program


# ---------------------------------------------------------------------------
# Table builders.
# ---------------------------------------------------------------------------

def _select_of(group, n: int, wave: int = 0) -> FusedSelect:
    gather = np.arange(n, dtype=np.int32)
    mask = np.zeros(n, bool)
    for st in group:
        for s, d in st.pairs:
            if mask[d]:  # the lowering guarantees distinct Match dests
                raise ValueError("Match group has a repeated destination")
            gather[d] = s
            mask[d] = True
    return FusedSelect(gather, mask, wave)


def _combine_of(group, n: int) -> FusedCombine:
    gathers: list[np.ndarray] = []
    masks: list[np.ndarray] = []
    for st in group:
        if st.link_pairs:
            g = np.arange(n, dtype=np.int32)
            m = np.zeros(n, bool)
            for s, d in st.link_pairs:
                g[d] = s
                m[d] = True
            gathers.append(g)
            masks.append(m)
        if st.self_mask_np.any():
            gathers.append(np.arange(n, dtype=np.int32))
            masks.append(st.self_mask_np.copy())
    return FusedCombine(np.stack(gathers), np.stack(masks))


def _build_alltoall(program: CollectiveProgram) -> tuple[FusedOp, ...]:
    assert all(isinstance(st, Perm) for st in program.comm_stages)
    src = np.concatenate([st.src_np for st in program.comm_stages])
    dst = np.concatenate([st.dst_np for st in program.comm_stages])
    starts = np.concatenate([
        np.full(len(st.src_np), st.start_step, np.int32)
        for st in program.comm_stages
    ])
    return (FusedExchange(src.astype(np.int32), dst.astype(np.int32), starts),)


def _build_allreduce(program: CollectiveProgram) -> tuple[FusedOp, ...]:
    return tuple(
        _combine_of(group, program.n) for group in program.step_groups()
    )


def _build_broadcast(program: CollectiveProgram) -> tuple[FusedOp, ...]:
    waves = program.num_rounds > 1
    return tuple(
        _select_of(group, program.n,
                   wave=group[0].round_index if waves else 0)
        for group in program.step_groups()
    )


def _build_matmul(program: CollectiveProgram) -> tuple[FusedOp, ...]:
    ops: list[FusedOp] = []
    for group in program.step_groups():
        st = group[0]
        if isinstance(st, LocalContract):
            mask = st.mask_np.copy() if st.fn == "store_c" else None
            ops.append(FusedLocal(st.fn, mask))
        elif isinstance(st, Match):
            ops.append(_select_of(group, program.n))
        elif isinstance(st, ReduceCombine):
            ops.append(_combine_of(group, program.n))
        else:  # pragma: no cover - Perm never appears in matmul programs
            raise TypeError(f"unexpected stage {st!r} in matmul program")
    return tuple(ops)


def _op_signature(op: FusedOp):
    if isinstance(op, FusedLocal):
        return ("local", op.fn)
    if isinstance(op, FusedSelect):
        return ("select",)
    if isinstance(op, FusedCombine):
        return ("combine", op.gather.shape[0])
    return ("exchange",)


def _matmul_round_template(program: CollectiveProgram,
                           ops: tuple[FusedOp, ...]) -> bool:
    """True iff every round fuses to the same op recipe (same op kinds and
    combine widths)."""
    rounds = program.num_rounds
    if rounds == 0 or len(ops) % rounds:
        return False
    period = len(ops) // rounds
    sig = [_op_signature(op) for op in ops]
    return all(sig[i] == sig[i % period] for i in range(len(sig)))


_BUILDERS = {
    "alltoall": _build_alltoall,
    "allreduce": _build_allreduce,
    "broadcast": _build_broadcast,
    "matmul": _build_matmul,
}


@functools.lru_cache(maxsize=None)
def optimize(program: CollectiveProgram) -> OptimizedProgram:
    """Fuse ``program`` into batched table ops (memoized per program)."""
    if isinstance(program, OptimizedProgram):
        return program
    ops = _BUILDERS[program.kind](program)
    uniform = (
        program.kind == "matmul" and _matmul_round_template(program, ops)
    )
    return OptimizedProgram(program, ops, uniform_rounds=uniform)


# ---------------------------------------------------------------------------
# NumPy replay (the reference backend's fused path).
# ---------------------------------------------------------------------------

def _expand(mask: np.ndarray, ndim: int):
    """Broadcast a (n,) mask over an array's trailing feature dims."""
    return mask.reshape(mask.shape + (1,) * (ndim - mask.ndim))


def np_alltoall(x: np.ndarray, opt: OptimizedProgram) -> np.ndarray:
    (op,) = opt.ops
    out = np.zeros_like(x)
    out[op.dst, op.src] = x[op.src, op.dst]
    return out


def np_allreduce(x: np.ndarray, opt: OptimizedProgram) -> np.ndarray:
    val = np.asarray(x).copy()
    for op in opt.ops:
        recv = np.zeros_like(val)
        for g, m in zip(op.gather, op.mask):
            recv[m] += val[g[m]]  # stage-order fold, masked rows only
        val = val + recv
    return val


def np_broadcast(x: np.ndarray, opt: OptimizedProgram) -> np.ndarray:
    waves = opt.program.num_rounds > 1
    val = np.asarray(x).copy()
    for op in opt.ops:
        sl = val[op.wave] if waves else val
        sel = np.where(_expand(op.mask, sl.ndim), sl[op.gather], sl)
        if waves:
            val[op.wave] = sel
        else:
            val = sel
    return val


def np_matmul_blocks(b: np.ndarray, a: np.ndarray,
                     opt: OptimizedProgram) -> np.ndarray:
    dtype = np.result_type(b, a)
    a = a.astype(dtype)
    val = np.zeros_like(b, dtype=dtype)
    acc = np.zeros_like(val)
    c = np.zeros_like(val)
    for op in opt.ops:
        if isinstance(op, FusedLocal):
            if op.fn == "load_b":
                val = b.astype(dtype).copy()
                acc = np.zeros_like(val)
            elif op.fn == "mul_a":
                val = np.einsum("nab,nbc->nac", val, a)
                acc = np.zeros_like(val)
            elif op.fn == "promote":
                val, acc = acc, np.zeros_like(acc)
            elif op.fn == "store_c":
                m = _expand(op.mask, c.ndim)
                c = np.where(m, val, c)
        elif isinstance(op, FusedSelect):
            val = np.where(_expand(op.mask, val.ndim), val[op.gather], val)
        else:
            for g, m in zip(op.gather, op.mask):
                acc[m] = acc[m] + val[g[m]]  # stage-order fold, masked rows
    return c


# ---------------------------------------------------------------------------
# Table stacking shared by the torch replay below and the cuda_fused kernels.
# ---------------------------------------------------------------------------

def stacked_combine_tables(opt: OptimizedProgram) -> tuple[np.ndarray, np.ndarray]:
    """(R, k, n) gather/mask tensors over an allreduce program's combine
    groups, narrow groups padded with identity-gather / zero-mask rows so
    every replay round (or kernel round) sees one table shape — a zero-masked
    row adds exact zeros, preserving bit-exactness. Shared by the torch
    replay below and the cuda_fused reduce kernel."""
    k = max(op.gather.shape[0] for op in opt.ops)
    n = opt.n
    ident = np.arange(n, dtype=np.int32)
    gat = np.stack([
        np.concatenate([op.gather,
                        np.broadcast_to(ident, (k - op.gather.shape[0], n))])
        for op in opt.ops
    ]).astype(np.int32)
    msk = np.stack([
        np.concatenate([op.mask,
                        np.zeros((k - op.mask.shape[0], n), bool)])
        for op in opt.ops
    ])
    return gat, msk


# ---------------------------------------------------------------------------
# Torch replay on device tensors. A Python loop over the tables takes the
# place of a scan; the tables reach the device once per (program, device).
# Gathers index with int64 here; the cuda_fused kernels take the int32
# tables as they are.
# ---------------------------------------------------------------------------

def to_device_tables(tables: Mapping[str, np.ndarray],
                     device: torch.device | str) -> dict[str, torch.Tensor]:
    """Upload plain numpy tables (gather / mask / src / dst / wave) to
    ``device``, each keeping its dtype: int32 index tables stay int32 and
    masks stay bool. This path has no weights — a program's tables are the
    only state that crosses to the device, and this is where it does."""
    return {key: torch.from_numpy(np.array(arr)).to(device)
            for key, arr in tables.items()}


def _rows(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """Broadcast a (n,) mask over a tensor's trailing feature dims."""
    return mask.reshape(mask.shape + (1,) * (ndim - mask.ndim))


def combine_fold(acc: torch.Tensor, val: torch.Tensor, gather: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Fold combine rows into ``acc`` in stage order (bit-exactness): row k
    adds ``where(mask[k], val[gather[k]], 0)``. A select, not a product
    with the mask, so -0.0, inf and NaN in unselected rows never leak."""
    zero = val.new_zeros(())
    for k in range(gather.shape[0]):
        acc = acc + torch.where(_rows(mask[k], val.ndim),
                                val[gather[k].long()], zero)
    return acc


def alltoall_tables(opt: OptimizedProgram) -> dict[str, np.ndarray]:
    (op,) = opt.ops
    return {"src": op.src, "dst": op.dst}


def allreduce_tables(opt: OptimizedProgram) -> dict[str, np.ndarray]:
    gat, msk = stacked_combine_tables(opt)
    return {"gather": gat, "mask": msk}


def broadcast_tables(opt: OptimizedProgram) -> dict[str, np.ndarray]:
    return {
        "gather": np.stack([op.gather for op in opt.ops]),
        "mask": np.stack([op.mask for op in opt.ops]),
        "wave": np.asarray([op.wave for op in opt.ops], np.int32),
    }


def replay_alltoall(x: torch.Tensor, src: torch.Tensor,
                    dst: torch.Tensor) -> torch.Tensor:
    """``out[dst, src] = x[src, dst]``: the native exchange's (src, dst)
    pairs are unique, so the scatter is deterministic."""
    src, dst = src.long(), dst.long()
    out = torch.zeros_like(x)
    out[dst, src] = x[src, dst]
    return out


def replay_allreduce(x: torch.Tensor, gather: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """R rounds over (R, k, n) tables: ``val += Σ_k where(mask, val[gather], 0)``."""
    val = x
    for r in range(gather.shape[0]):
        val = val + combine_fold(torch.zeros_like(val), val, gather[r], mask[r])
    return val


def replay_broadcast(x: torch.Tensor, gather: torch.Tensor, mask: torch.Tensor,
                     wave: Sequence[int], waves: bool) -> torch.Tensor:
    """Masked-gather groups in order. Multi-round (wave) programs act on
    slice ``x[wave]`` of a copy of ``x``, updated in place."""
    val = x.clone() if waves else x
    for g, m, w in zip(gather, mask, wave):
        sl = val[w] if waves else val
        sel = torch.where(_rows(m, sl.ndim), sl[g.long()], sl)
        if waves:
            val[w] = sel
        else:
            val = sel
    return val


@functools.lru_cache(maxsize=None)
def torch_alltoall(opt: OptimizedProgram, device: torch.device):
    t = to_device_tables(alltoall_tables(opt), device)
    return functools.partial(replay_alltoall, src=t["src"], dst=t["dst"])


@functools.lru_cache(maxsize=None)
def exchange_waves(opt: OptimizedProgram) -> tuple[tuple[int, np.ndarray, np.ndarray], ...]:
    """The fused §3 exchange table sliced per launch wave: one
    ``(start_step, src, dst)`` triple per distinct ``FusedExchange.starts``
    value, in launch order. A table without stamps is a single wave; the
    barrier schedule's lowering stamps each round apart, one wave a round;
    a ``pipelined_schedule`` program yields one slice per Schedule-1..3
    launch stamp (``core.alltoall.round_starts``), the launch
    order of ``torch_alltoall_overlapped`` and of ``torch_dist``'s
    ``overlap_fused`` replays. Stamps are per stage, so a stage's pairs
    always land in one wave."""
    (op,) = opt.ops
    starts = (op.starts if op.starts is not None
              else np.zeros(len(op.src), np.int32))
    out = []
    for s in np.unique(starts):
        sel = starts == s
        out.append((int(s), op.src[sel].copy(), op.dst[sel].copy()))
    return tuple(out)


def _wave_tables(opt: OptimizedProgram) -> tuple[np.ndarray, np.ndarray]:
    """(W, V) src/dst tables, one row per wave, narrow waves padded by
    REPEATING their own pairs from the first on (``np.resize``), never by
    masking: a repeated (src, dst) writes the same value to the same slot,
    so padding cannot perturb results (no masked adds that would rewrite
    -0.0)."""
    waves = exchange_waves(opt)
    v = max(len(s) for _, s, _ in waves)
    src = np.stack([np.resize(s, v) for _, s, _ in waves]).astype(np.int32)
    dst = np.stack([np.resize(d, v) for _, _, d in waves]).astype(np.int32)
    return src, dst


def replay_alltoall_overlapped(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                               compute=None) -> torch.Tensor:
    """Wave-by-wave replay of the fused exchange over (W, V) tables with a
    double buffer: wave w's rows are pending while wave w-1's already
    arrived chunks commit, and the last pending wave drains after the loop.
    Without ``compute``: ``out[dst, src] = x[src, dst]``. With it, the
    round trip ``out[src, dst] = compute(x[src, dst], dst)``."""
    def commit(out, psrc, pdst):
        psrc, pdst = psrc.long(), pdst.long()
        if compute is None:
            out[pdst, psrc] = x[psrc, pdst]
        else:
            out[psrc, pdst] = compute(x[psrc, pdst], pdst).to(out.dtype)
        return out

    out, pending = torch.zeros_like(x), None
    for w in range(src.shape[0]):
        if pending is not None:  # wave w rides as pending; wave w-1 commits
            out = commit(out, *pending)
        pending = (src[w], dst[w])
    return commit(out, *pending)  # drain the last pending wave


@functools.lru_cache(maxsize=None)
def torch_alltoall_overlapped(opt: OptimizedProgram, device: torch.device, compute=None):
    """The wave-ordered replay of ``opt``'s exchange on ``device``, the
    counterpart of the JAX package's ``jax_alltoall_overlapped``. Without
    ``compute`` it is the one-way exchange, bit-identical to
    ``torch_alltoall``. With it, the dispatch -> process -> combine round
    trip: ``compute(chunks, dst_ids)`` takes one wave's stacked (V, ...)
    chunks and their (V,) destination ids and returns the processed
    (V, ...) stack."""
    src, dst = _wave_tables(opt)
    t = to_device_tables({"src": src, "dst": dst}, device)
    return functools.partial(replay_alltoall_overlapped, src=t["src"], dst=t["dst"],
                             compute=compute)


@functools.lru_cache(maxsize=None)
def torch_allreduce(opt: OptimizedProgram, device: torch.device):
    t = to_device_tables(allreduce_tables(opt), device)
    return functools.partial(replay_allreduce, gather=t["gather"], mask=t["mask"])


@functools.lru_cache(maxsize=None)
def torch_broadcast(opt: OptimizedProgram, device: torch.device):
    t = to_device_tables(broadcast_tables(opt), device)
    return functools.partial(replay_broadcast, gather=t["gather"], mask=t["mask"],
                             wave=t["wave"].tolist(),
                             waves=opt.program.num_rounds > 1)


def matmul_tables(opt: OptimizedProgram) -> tuple[tuple[str, str | None, dict], ...]:
    """The §2 replay recipe: per fused op, in program order, its kind
    (``local`` / ``select`` / ``combine``), its local function name and its
    numpy tables."""
    recipe = []
    for op in opt.ops:
        if isinstance(op, FusedLocal):
            tabs = {"mask": op.mask} if op.fn == "store_c" else {}
            recipe.append(("local", op.fn, tabs))
        else:
            kind = "select" if isinstance(op, FusedSelect) else "combine"
            recipe.append((kind, None, {"gather": op.gather, "mask": op.mask}))
    return tuple(recipe)


def replay_matmul(recipe, b: torch.Tensor, a: torch.Tensor, *,
                  mul_fn=None, combine_fn=None) -> torch.Tensor:
    """The fused §2 replay on (n, X, X) blocks over a recipe whose tables
    are on the device. ``mul_fn(val, a)`` / ``combine_fn(acc, val, gather,
    mask)`` are the hooks the cuda_fused backend routes through its
    kernels; the defaults are plain torch."""
    mul = mul_fn or torch.matmul
    comb = combine_fn or combine_fold
    dtype = torch.result_type(b, a)
    b, a = b.to(dtype), a.to(dtype)
    val = acc = c = torch.zeros_like(b)
    for kind, fn, t in recipe:
        if kind == "local":
            if fn == "load_b":
                val, acc = b, torch.zeros_like(acc)
            elif fn == "mul_a":
                val, acc = mul(val, a), torch.zeros_like(acc)
            elif fn == "promote":
                val, acc = acc, torch.zeros_like(acc)
            elif fn == "store_c":
                c = torch.where(_rows(t["mask"], c.ndim), val, c)
        elif kind == "select":
            val = torch.where(_rows(t["mask"], val.ndim),
                              val[t["gather"].long()], val)
        else:
            acc = comb(acc, val, t["gather"], t["mask"])
    return c


def build_torch_matmul(opt: OptimizedProgram, device: torch.device, *,
                       mul_fn=None, combine_fn=None):
    """``replay_matmul`` bound to the program's tables on ``device``."""
    recipe = tuple((kind, fn, to_device_tables(tabs, device))
                   for kind, fn, tabs in matmul_tables(opt))
    return functools.partial(replay_matmul, recipe,
                             mul_fn=mul_fn, combine_fn=combine_fn)


@functools.lru_cache(maxsize=None)
def torch_matmul_blocks(opt: OptimizedProgram, device: torch.device):
    return build_torch_matmul(opt, device)


# ---------------------------------------------------------------------------
# Whole-matrix matmul wrapper: scatter the (N·X, N·X) operands to router
# blocks (and guest blocks to their host slots) on the device.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _block_index(grid: tuple[int, int]) -> tuple[np.ndarray, np.ndarray]:
    """Router-id-ordered (block-row, block-col) index arrays of the §2
    storage map (host-built once per grid)."""
    from repro_torch.core.matmul import MatmulGrid, block_of_router

    g = MatmulGrid(*grid)
    bi = np.empty(g.topo.num_routers, np.int32)
    bj = np.empty(g.topo.num_routers, np.int32)
    for r in g.topo.routers():
        i, j = block_of_router(g, r)
        rid = g.topo.router_id(r)
        bi[rid], bj[rid] = i, j
    return bi, bj


def _block_index_on(grid: tuple[int, int], device: torch.device):
    bi, bj = _block_index(grid)
    return (torch.from_numpy(bi).long().to(device),
            torch.from_numpy(bj).long().to(device))


def torch_scatter_blocks(mat: torch.Tensor, grid: tuple[int, int]) -> torch.Tensor:
    """(N·X, N·X) -> contiguous (n_routers, X, X) on ``mat``'s device
    (torch twin of ``core.matmul.scatter_blocks``)."""
    bi, bj = _block_index_on(grid, mat.device)
    N = grid[0] * grid[1]
    X = mat.shape[0] // N
    blocks = mat.reshape(N, X, N, X).permute(0, 2, 1, 3)
    return blocks[bi, bj].contiguous()


def torch_gather_blocks(blocks: torch.Tensor, grid: tuple[int, int]) -> torch.Tensor:
    """(n_routers, X, X) -> (N·X, N·X) on ``blocks``' device."""
    bi, bj = _block_index_on(grid, blocks.device)
    N = grid[0] * grid[1]
    X = blocks.shape[1]
    out = blocks.new_zeros((N, N, X, X))
    out[bi, bj] = blocks
    return out.permute(0, 2, 1, 3).reshape(N * X, N * X)


def torch_scatter_guest(x: torch.Tensor, program: CollectiveProgram, *,
                        axes=(0,)) -> torch.Tensor:
    """Torch twin of ``rewrite.scatter_guest`` (identity for native)."""
    if program.active_devices is None:
        return x
    idx = torch.from_numpy(program.active_np).long().to(x.device)
    out = x
    for ax in axes:
        shape = list(out.shape)
        shape[ax] = program.n
        sel = [slice(None)] * out.ndim
        sel[ax] = idx
        host = out.new_zeros(shape)
        host[tuple(sel)] = out
        out = host
    return out


def torch_gather_guest(x: torch.Tensor, program: CollectiveProgram, *,
                       axes=(0,)) -> torch.Tensor:
    if program.active_devices is None:
        return x
    idx = torch.from_numpy(program.active_np).long().to(x.device)
    out = x
    for ax in axes:
        sel = [slice(None)] * out.ndim
        sel[ax] = idx
        out = out[tuple(sel)]
    return out
