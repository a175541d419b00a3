"""Batched block product ``C[z] = A[z] @ B[z]`` with an fp32 accumulator —
the "off-and-on" local product of the D3(K², M) distributed matmul (§2,
Theorem 2's X×X block product), as one CUDA kernel over the whole batch.

Kernel: ``csrc/block_matmul.cu``, which says what bounds it on the H100 and
how its tiling answers that. This wrapper takes the plain version
(``ref.block_matmul_ref``) for CPU tensors only; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.block_matmul.ref import block_matmul_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def block_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(batch, M, K) @ (batch, K, N) -> (batch, M, N) in ``a``'s dtype.

    Float32 runs in full float32 (no TF32); bf16 accumulates in float32
    and rounds once on store. Every launch adds one to
    ``block_matmul.launches``."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return block_matmul_ref(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"block_matmul takes CPU or same-card CUDA tensors, "
                         f"got {a.device} and {b.device}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"block_matmul takes float32 or bfloat16 operands of one "
                        f"dtype, got {a.dtype} and {b.dtype}")
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or a.shape[2] != b.shape[1]:
        raise ValueError(f"expected (batch, M, K) @ (batch, K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("block_matmul takes contiguous operands")
    batch, M, K = a.shape
    N = b.shape[2]
    c = torch.empty((batch, M, N), dtype=a.dtype, device=a.device)
    if c.numel() == 0:
        return c.zero_()
    lib = build.load("block_matmul")
    with torch.cuda.device(a.device):
        err = lib.block_matmul_launch(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                      batch, M, N, K, _DTYPES[a.dtype],
                                      torch.cuda.current_stream().cuda_stream)
    build.check(err, "block_matmul launch")
    block_matmul.launches += 1
    return c


block_matmul.launches = 0
