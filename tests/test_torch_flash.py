"""Flash attention (K4): the port against the JAX package, on the CPU.

The same inputs, made by numpy from a seed, go through the JAX package's
``flash_attention`` in interpret mode and through the port's wrapper,
which takes its plain torch version for CPU tensors. The cases are
``tests/test_kernels.py``'s; the JAX kernel's (BH, S, D) operands reach the
port as (BH, S, 1, D), one head each. Tolerances: float32 within rtol = atol = 2e-4
(the sums run in another order), bf16 within 3e-2 (one bf16 rounding of p
and of the output). Where both sides run the same recurrence in float32
at the same tiles, the outputs agree to 1e-5.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.flash_attention.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention.ops import gqa_attention_impl as j_gqa_impl
from repro.kernels.flash_attention.ref import attention_ref as j_ref

from repro_torch.kernels.flash_attention import ops as t_ops
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention, flash_attention_plain)
from repro_torch.kernels.flash_attention.ref import attention_ref

F32_TOL = 2e-4
BF16_TOL = 3e-2


def qkv(seed, shapes, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jax_side = [jnp.asarray(a, dtype) for a in arrays]
    torch_side = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jax_side, torch_side


def one_head(*ts):
    """(BH, S, D) -> (BH, S, 1, D), the port's layout with one head."""
    return [t[:, :, None] for t in ts]


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(128, 128), (128, 256)])
def test_flash_matches_pallas(causal, sq, sk):
    (jq, jk, jv), (q, k, v) = qkv(2, [(4, sq, 64), (4, sk, 64), (4, sk, 64)])
    q, k, v = one_head(q, k, v)
    want = j_flash(jq, jk, jv, causal=causal, bq=64, bk=64, interpret=True)
    close(flash_attention(q, k, v, causal=causal)[:, :, 0], want, F32_TOL)
    # the same recurrence at the same tiles
    close(flash_attention_plain(q, k, v, causal=causal, bq=64, bk=64)[:, :, 0], want, 1e-5)


def test_flash_sliding_window():
    (jq, jk, jv), (q, k, v) = qkv(3, [(2, 256, 64)] * 3)
    q, k, v = one_head(q, k, v)
    want = j_flash(jq, jk, jv, causal=True, window=64, bq=64, bk=64, interpret=True)
    close(flash_attention(q, k, v, causal=True, window=64)[:, :, 0], want, F32_TOL)
    close(flash_attention_plain(q, k, v, causal=True, window=64, bq=64, bk=64)[:, :, 0],
          want, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_dtypes(dtype):
    (jq, jk, jv), (q, k, v) = qkv(4, [(2, 128, 64)] * 3, dtype)
    want = j_flash(jq, jk, jv, bq=64, bk=64, interpret=True)
    got = flash_attention(*one_head(q, k, v))[:, :, 0]
    assert got.dtype == q.dtype
    close(got, want, BF16_TOL if dtype == "bfloat16" else F32_TOL)


def test_flash_kv_tile_independence():
    """Property: the result does not depend on the key tile (online softmax)."""
    _, (q, k, v) = qkv(6, [(2, 256, 4, 64)] * 3)
    a = flash_attention_plain(q, k, v, bq=64, bk=64)
    b = flash_attention_plain(q, k, v, bq=64, bk=256)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [None, 32])
@pytest.mark.parametrize("sq,sk", [(100, 100), (70, 130), (130, 70)])
def test_flash_ragged_lengths_match_the_oracle(sq, sk, window):
    """Lengths that no tile divides, Sq != Sk with positions counted from 0,
    and a window: the plain version at ragged tiles against attention_ref,
    including rows that see no key (Sq > Sk + window - 1), which give 0."""
    (jq, jk, jv), (q, k, v) = qkv(7, [(3, sq, 32), (3, sk, 32), (3, sk, 32)])
    want = j_ref(jq, jk, jv, causal=True, window=window)
    got = flash_attention_plain(*one_head(q, k, v), causal=True, window=window, bq=64, bk=48)
    close(got[:, :, 0], want, F32_TOL)
    close(attention_ref(q, k, v, causal=True, window=window), want, 1e-5)


@pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 2), (4, 1)])
def test_gqa_grouping_matches_pallas(hq, hkv):
    B, S, D = 2, 128, 32
    (jq, jk, jv), (q, k, v) = qkv(5, [(B, S, hq, D), (B, S, hkv, D), (B, S, hkv, D)])
    want = j_gqa_impl(jq, jk, jv, impl="pallas", interpret=True)
    close(t_ops.gqa_attention(q, k, v, use_kernel=True), want, F32_TOL)
    naive = j_gqa_impl(jq, jk, jv, impl="naive")
    close(t_ops.gqa_attention(q, k, v, use_kernel=False), naive, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_head_dim_96_matches_pallas(dtype):
    """Phi-3-mini's head_dim (3072 / 32), with its 32 query and KV heads cut
    to 4, against the Pallas kernel through the GQA entry."""
    (jq, jk, jv), (q, k, v) = qkv(8, [(2, 160, 4, 96)] * 3, dtype)
    want = j_gqa_impl(jq, jk, jv, impl="pallas", interpret=True)
    got = t_ops.gqa_attention(q, k, v, use_kernel=True)
    assert got.dtype == q.dtype
    close(got, want, BF16_TOL if dtype == "bfloat16" else F32_TOL)


def test_wrapper_refuses_devices_without_a_kernel():
    """No silent fallback: only CPU tensors take the plain version; the
    meta device takes the kernel's op (its fake: shapes only), and
    operands on two devices are refused."""
    x = torch.empty((2, 64, 4, 64), device="meta")
    out = flash_attention(x, x, x)
    assert out.is_meta and out.shape == x.shape
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(x, x, torch.empty((2, 64, 4, 64)))
    with pytest.raises(ValueError, match="impl"):
        t_ops.gqa_attention_impl(x, x, x, impl="xla")


@pytest.mark.parametrize("shapes", [
    [(2, 64, 4, 32), (2, 64, 3, 32), (2, 64, 3, 32)],   # 3 KV heads do not divide 4
    [(2, 64, 4, 32), (2, 64, 2, 16), (2, 64, 2, 16)],   # head dims differ
    [(2, 64, 32), (2, 64, 32), (2, 64, 32)],            # the (BH, S, D) layout
])
def test_wrapper_refuses_shapes_that_do_not_fit(shapes):
    _, (q, k, v) = qkv(9, shapes)
    with pytest.raises(ValueError):
        flash_attention(q, k, v)
