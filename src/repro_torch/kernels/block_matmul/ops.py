"""Public entry points of the block matmul kernel. The kernel runs on CUDA
tensors; CPU tensors take the plain torch version (the tests' path)."""

import torch

from repro_torch.kernels.block_matmul.block_matmul import block_matmul
from repro_torch.kernels.block_matmul.ref import block_matmul_ref


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One (M, K) @ (K, N) product through the batched kernel."""
    return block_matmul(a[None], b[None])[0]


def batched_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched block product ``(n, X, X) @ (n, X, X) -> (n, X, X)`` in one
    launch, the batch a grid dimension of the kernel — the §2 off-network
    ``mul_a`` contraction of the program executor."""
    return block_matmul(a, b)


__all__ = ["matmul", "batched_matmul", "block_matmul", "block_matmul_ref"]
