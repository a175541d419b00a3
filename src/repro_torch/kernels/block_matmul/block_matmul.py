"""Batched block product ``C[z] = A[z] @ B[z]`` with an fp32 accumulator —
the "off-and-on" local product of the D3(K², M) distributed matmul (§2,
Theorem 2's X×X block product), as one CUDA kernel over the whole batch.

Kernel: ``csrc/block_matmul.cu``, which says what bounds it on the H100 and
how its two bodies answer that. This wrapper takes the plain version
(``ref.block_matmul_ref``) for CPU tensors only; on a CUDA tensor it
launches the kernel or raises.

Which body runs is a rule on dtype and shape (``body_for``), never the
outcome of a build or a launch:

* ``"tf32x3"`` for float32 operands whose rows TMA can tile: K and N
  multiples of 4 (rows of whole 16-byte units) and both bases 16-byte
  aligned. wgmma on the tensor cores, each product split into TF32 high
  and low parts and taken as hi·hi + hi·lo + lo·hi in float32: bit-exact
  on integer-valued inputs whose partial sums stay below 2^24 (the §2
  contract's [-4, 4] at X = 512: lo = 0 and every sum is an integer), and
  within rtol = atol = 2e-4 of the float32 product on random normals at
  X = 512, about as near the exact product as that is (``chip_smoke.py``
  prints both distances).
* ``"simt"`` otherwise — the §2 grids' X = 2 and 3 (rows of 8 or 12 bytes)
  and every bf16 product: the FFMA body in full float32, bf16 widened,
  accumulated in float32 and rounded once on store.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.block_matmul.ref import block_matmul_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BODIES = {"simt": 0, "tf32x3": 1}


def body_for(dtype: torch.dtype, M: int, N: int, K: int, aligned: bool = True) -> str:
    """The body the kernel runs for these operands (module docstring);
    ``aligned``: both bases are 16-byte aligned."""
    if dtype == torch.float32 and K % 4 == 0 and N % 4 == 0 and aligned:
        return "tf32x3"
    return "simt"


def block_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(batch, M, K) @ (batch, K, N) -> (batch, M, N) in ``a``'s dtype.

    The body follows ``body_for`` (module docstring); with no depth
    (K = 0) the product is zeros and nothing is launched. Every launch adds
    one to ``block_matmul.launches`` and to its body's entry of
    ``block_matmul.body_launches``."""
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
    if c.numel() == 0 or K == 0:
        return c.zero_()
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    body = body_for(a.dtype, M, N, K, aligned)
    lib = build.load("block_matmul")
    with torch.cuda.device(a.device):
        err = lib.block_matmul_launch(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                      batch, M, N, K, _DTYPES[a.dtype], BODIES[body],
                                      torch.cuda.current_stream().cuda_stream)
    build.check(err, "block_matmul launch")
    block_matmul.launches += 1
    block_matmul.body_launches[body] += 1
    return c


block_matmul.launches = 0
block_matmul.body_launches = dict.fromkeys(BODIES, 0)
