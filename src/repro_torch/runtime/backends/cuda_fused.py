"""CUDA-fused backend: fused table replay with hand-written CUDA kernels on
the reduce and contraction hot spots.

Replays the OPTIMIZED form of a program (``runtime.optimize``) on torch
tensors and pushes the compute into kernels of ``repro_torch/csrc``:

  * ``run_allreduce`` — every §4 round in ONE launch of the reduce-rounds
    kernel (``reduce_rounds``): each block keeps an (n, block_f) column slab
    of the buffer in shared memory across all rounds, driven by the stacked
    (gather, mask) tables;
  * ``run_matmul`` — the §2 replay with its combine groups on the same
    kernel at R = 1 (``combine_rows``) and its ``mul_a`` contraction on the
    batched block-product kernel (``kernels/block_matmul``).

``run_alltoall`` and ``run_broadcast`` are pure data movement with no
compute to fuse: they are the optimizer's torch table replays (one batched
scatter; one masked gather per group).

``CudaFusedBackend()`` runs on the card and raises where there is none;
``CudaFusedBackend(device="cpu")`` runs the same replay with every kernel's
plain torch version, which is how the tests reach it. Inputs may be numpy
arrays or tensors; results are tensors on the backend's device, in the
input's dtype.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.block_matmul.ops import batched_matmul
from repro_torch.runtime import optimize as _opt
from repro_torch.runtime.program import check_kind as _check_kind


# ---------------------------------------------------------------------------
# Kernels: the reduce rounds (csrc/reduce_rounds.cu) and their plain versions.
# ---------------------------------------------------------------------------

#: The reduce kernel's plain version at R rounds is the optimizer's torch replay.
_reduce_rounds_plain = _opt.replay_allreduce


def _combine_rows_plain(flat: torch.Tensor, gather: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    return _opt.combine_fold(torch.zeros_like(flat), flat, gather, mask)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _slab_floats() -> int:
    return build.load("reduce_rounds").reduce_rounds_slab_floats()


def column_shift(n: int, features: int, slab_floats: int) -> int:
    """log2 of the kernel's column tile ``block_f``: the widest power of
    two whose (n, block_f) slab fits ``slab_floats``, and no wider than
    the buffer needs."""
    if n > slab_floats:
        raise ValueError(f"n={n} rows exceed the {slab_floats}-float slab")
    shift = 0
    while (n << (shift + 1)) <= slab_floats and (1 << shift) < features:
        shift += 1
    return shift


def _launch_rounds(flat, gather, mask, *, self_add: bool, what: str):
    if flat.device.type != "cuda" or gather.device != flat.device or mask.device != flat.device:
        raise ValueError(f"{what} takes CPU or same-card CUDA tensors, got "
                         f"{flat.device}, {gather.device}, {mask.device}")
    if flat.dtype not in _DTYPES:
        raise TypeError(f"{what} takes float32 or bfloat16 on the card, got {flat.dtype}")
    if gather.dtype != torch.int32 or mask.dtype != torch.bool:
        raise TypeError(f"{what} takes int32 gather and bool mask tables, got "
                        f"{gather.dtype} and {mask.dtype}")
    if (flat.dim() != 2 or gather.dim() != 3 or mask.shape != gather.shape
            or gather.shape[2] != flat.shape[0]):
        raise ValueError(f"{what}: expected (n, F) values and (R, k, n) tables, got "
                         f"{tuple(flat.shape)}, {tuple(gather.shape)}, {tuple(mask.shape)}")
    if not (flat.is_contiguous() and gather.is_contiguous() and mask.is_contiguous()):
        raise ValueError(f"{what} takes contiguous values and tables")
    n, features = flat.shape
    rounds, k_rows, _ = gather.shape
    out = torch.empty_like(flat)
    if out.numel() == 0:
        return out
    shift = column_shift(n, features, _slab_floats())
    with torch.cuda.device(flat.device):
        err = build.load("reduce_rounds").reduce_rounds_launch(
            flat.data_ptr(), out.data_ptr(), gather.data_ptr(), mask.data_ptr(),
            rounds, k_rows, n, features, shift, int(self_add), _DTYPES[flat.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check(err, f"{what} launch")
    return out


def reduce_rounds(flat: torch.Tensor, gather: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """K1, the §4 all-reduce replay in one launch: for each of R rounds,
    ``val += Σ_k where(mask[r, k], val[gather[r, k]], 0)`` folded in k
    order. ``flat`` is (n, F) float32 or bfloat16 (each bf16 add is rounded
    at once, as a torch bf16 add is); the tables are (R, k, n) int32 / bool
    (``optimize.stacked_combine_tables``), gathers in [0, n) as ``optimize``
    builds them (the kernel does not check). Bit-exact with the plain
    version. Every launch adds one to ``reduce_rounds.launches``."""
    if flat.device.type == "cpu":
        return _reduce_rounds_plain(flat, gather, mask)
    out = _launch_rounds(flat, gather, mask, self_add=True, what="reduce_rounds")
    reduce_rounds.launches += 1
    return out


def combine_rows(flat: torch.Tensor, gather: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """K2, one §2 ReduceCombine group: ``Σ_k where(mask[k], val[gather[k]], 0)``
    in stage order over (n, F) rows, with (k, n) tables. The reduce-rounds
    kernel at R = 1 without the self-add. Every launch adds one to
    ``combine_rows.launches``."""
    if flat.device.type == "cpu":
        return _combine_rows_plain(flat, gather, mask)
    out = _launch_rounds(flat, gather[None], mask[None], self_add=False,
                         what="combine_rows")
    combine_rows.launches += 1
    return out


reduce_rounds.launches = 0
combine_rows.launches = 0


def _combine_fn(acc, val, gather, mask):
    """The §2 combine hook: ``acc + combine_rows(val)``. The §2 program
    zeroes ``acc`` before every combine group, so this equals the plain
    fold straight into ``acc`` bit for bit."""
    n = val.shape[0]
    return acc + combine_rows(val.reshape(n, -1), gather, mask).reshape(val.shape)


@functools.lru_cache(maxsize=None)
def _matmul_executor(opt: _opt.OptimizedProgram, device: torch.device):
    return _opt.build_torch_matmul(opt, device, mul_fn=batched_matmul,
                                   combine_fn=_combine_fn)


@functools.lru_cache(maxsize=None)
def _allreduce_tables(opt: _opt.OptimizedProgram, device: torch.device):
    return _opt.to_device_tables(_opt.allreduce_tables(opt), device)


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
        return reduce_rounds(flat, t["gather"], t["mask"]).reshape(x.shape)

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
