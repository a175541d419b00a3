"""The block product (K3) and flash attention (K4): the arithmetic of the
tensor-core bodies and the rule that picks each wrapper's body, on the CPU.

K3's float32 body on the card splits every operand x into a TF32 part
hi = x with its low 13 mantissa bits cleared and lo = x - hi, and takes
A·B as A_hi·B_hi + A_hi·B_lo + A_lo·B_hi, each 32-deep stage summed on its
own and added to the running float32 sum. ``tf32x3`` below repeats that
with torch bit masking: lo, fed to the tensor cores, loses its own low 13
bits too; products of TF32 values are exact in float32. The CPU cannot run
the kernel, but it can show that the split is exact where the §2 contract
needs it (integer-valued inputs in [-4, 4] at X = 512: bit-equal to the
float32 product) and close elsewhere (random normals: within the
rtol = atol = 2e-4 that ``chip_smoke.py`` holds the kernel to). This file
imports no jax.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.block_matmul import block_matmul as k3
from repro_torch.kernels.block_matmul.block_matmul import block_matmul
from repro_torch.kernels.block_matmul.block_matmul import body_for as matmul_body
from repro_torch.kernels.block_matmul.ref import block_matmul_ref
from repro_torch.kernels.flash_attention import flash_attention as k4
from repro_torch.kernels.flash_attention.flash_attention import body_for as flash_body
from repro_torch.kernels.flash_attention.flash_attention import flash_attention

STAGE = 32  # K3's stage depth: one 128-byte row of float32


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its low 13 mantissa bits cleared (non-finite x kept)."""
    hi = (x.view(torch.int32) & -8192).view(torch.float32)  # -8192 == 0xffffe000
    return torch.where(torch.isfinite(x), hi, x)


def split(x: torch.Tensor):
    hi = tf32(x)
    lo = torch.where(torch.isfinite(x), x - hi, torch.zeros_like(x))
    return hi, lo


def tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(batch, M, K) @ (batch, K, N) as the kernel's tf32x3 body takes it."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    a_lo, b_lo = tf32(a_lo), tf32(b_lo)
    acc = torch.zeros(a.shape[0], a.shape[1], b.shape[2], dtype=torch.float32)
    for k0 in range(0, a.shape[2], STAGE):
        ks = slice(k0, k0 + STAGE)
        part = (torch.matmul(a_lo[..., ks], b_hi[:, ks]) + torch.matmul(a_hi[..., ks], b_lo[:, ks])
                + torch.matmul(a_hi[..., ks], b_hi[:, ks]))
        acc = acc + part
    return acc


def test_split_is_exact_and_hi_fits_tf32():
    rng = np.random.default_rng(20)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 1e3)
    hi, lo = split(x)
    assert torch.equal(hi + lo, x)  # x - hi is exact in float32
    assert not bool((hi.view(torch.int32) & 0x1FFF).any())  # 10 mantissa bits left
    assert bool((lo.abs() <= x.abs() * 2.0 ** -10).all())
    ints = torch.arange(-4, 5, dtype=torch.float32)
    assert torch.equal(split(ints)[0], ints) and not bool(split(ints)[1].any())


def test_split_keeps_non_finite_values_in_hi():
    x = torch.tensor([float("inf"), float("-inf"), float("nan"), 0.0, -0.0])
    hi, lo = split(x)
    assert torch.equal(hi[:2], x[:2]) and bool(torch.isnan(hi[2]))
    assert not bool(lo.any())


@pytest.mark.parametrize("batch", [1, 2])
def test_tf32x3_is_bit_exact_on_integers_at_x512(batch):
    """The §2 contract's inputs: lo is 0, every product of TF32 values is
    exact and every partial sum an integer below 2^24."""
    rng = np.random.default_rng(21 + batch)
    a = torch.from_numpy(rng.integers(-4, 5, (batch, 512, 512)).astype(np.float32))
    b = torch.from_numpy(rng.integers(-4, 5, (batch, 512, 512)).astype(np.float32))
    got, want = tf32x3(a, b), block_matmul_ref(a, b)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_tf32x3_is_close_on_normals_at_x512():
    rng = np.random.default_rng(23)
    a = torch.from_numpy(rng.standard_normal((2, 512, 512)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 512, 512)).astype(np.float32))
    got = tf32x3(a, b)
    exact = torch.matmul(a.double(), b.double())
    torch.testing.assert_close(got, block_matmul_ref(a, b), rtol=2e-4, atol=2e-4)
    assert float((got.double() - exact).abs().max()) < 1e-4


def test_one_tf32_product_is_not_enough():
    """Why three products: TF32 alone is off by ~1e-2 at X = 512 on normals."""
    rng = np.random.default_rng(24)
    a = torch.from_numpy(rng.standard_normal((1, 512, 512)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((1, 512, 512)).astype(np.float32))
    one = torch.matmul(tf32(a), tf32(b))
    assert not torch.allclose(one, block_matmul_ref(a, b), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype,m,n,k,aligned,body", [
    (torch.float32, 512, 512, 512, True, "tf32x3"),    # the main path's shape
    (torch.float32, 4, 4, 4, True, "tf32x3"),          # X = 4: 16-byte rows
    (torch.float32, 2, 2, 2, True, "simt"),            # X = 2: 8-byte rows
    (torch.float32, 3, 3, 3, True, "simt"),            # X = 3: 12-byte rows
    (torch.float32, 130, 132, 68, True, "tf32x3"),     # M, N, K off the tile
    (torch.float32, 130, 129, 68, True, "simt"),       # N not a multiple of 4
    (torch.float32, 130, 132, 67, True, "simt"),       # K not a multiple of 4
    (torch.float32, 512, 512, 512, False, "simt"),     # a base off 16 bytes
    (torch.bfloat16, 512, 512, 512, True, "simt"),     # bf16 keeps the FFMA body
])
def test_block_matmul_body_rule(dtype, m, n, k, aligned, body):
    assert matmul_body(dtype, m, n, k, aligned) == body


@pytest.mark.parametrize("dtype,body", [(torch.bfloat16, "wgmma"), (torch.float32, "mma_sync")])
def test_flash_attention_body_rule(dtype, body):
    assert flash_body(dtype) == body



@pytest.mark.parametrize("kernel,args", [
    ("block_matmul", lambda: (torch.ones(2, 4, 4), torch.ones(2, 4, 4))),
    ("flash_attention", lambda: (torch.ones(1, 4, 2, 64), torch.ones(1, 4, 1, 64),
                                 torch.ones(1, 4, 1, 64))),
])
def test_cpu_calls_count_no_body(kernel, args):
    """Each wrapper counts a launch per body, keyed by its bodies; the plain
    version a CPU tensor takes launches nothing and counts nothing."""
    fn, module = {"block_matmul": (block_matmul, k3), "flash_attention": (flash_attention, k4)}[kernel]
    assert set(fn.body_launches) == set(module.BODIES)
    before = (fn.launches, dict(fn.body_launches))
    fn(*args())
    assert (fn.launches, fn.body_launches) == before
