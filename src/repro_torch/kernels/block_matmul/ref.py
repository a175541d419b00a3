"""Plain torch oracle for the block matmul kernel: fp32 accumulation,
output in ``a``'s dtype unless ``out_dtype`` is given."""

import torch


def block_matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    if out_dtype is None:
        out_dtype = a.dtype
    return torch.matmul(a.float(), b.float()).to(out_dtype)
