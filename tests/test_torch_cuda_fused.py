"""The port's kernels and the cuda_fused backend, without the JAX package.

CPU tests hold each kernel wrapper's plain path (the one it takes for CPU
tensors) to the port's NumPy replays, and check the tiling arithmetic and
the refusals that stay in Python. Tests marked ``gpu`` hold each CUDA
kernel to its plain version on the card, at small shapes that reach every
tail; they decide inside the test (through the ``cuda`` fixture) whether
there is a card and skip where there is none. This file imports no jax, so
it runs as it is on a machine with a card:

    python -m pytest -q -m gpu tests/test_torch_cuda_fused.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import matmul as mm
from repro_torch.core.topology import D3
from repro_torch.dist import collectives as dc
from repro_torch.dist.mesh import DeviceLayout
from repro_torch.kernels.block_matmul.block_matmul import block_matmul
from repro_torch.kernels.block_matmul.block_matmul import body_for as matmul_body
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention, flash_attention_plain, refuse_grad)
from repro_torch.kernels.block_matmul.ref import block_matmul_ref
from repro_torch.runtime import optimize as opt
from repro_torch.runtime.backends import cuda_fused as cf
from repro_torch.runtime.backends.reference import NumpyReferenceBackend

REF = NumpyReferenceBackend()
LAYOUTS = [(2, 2), (4, 2), (2, 4), (4, 4)]
GRIDS = [(1, 2), (2, 2), (1, 3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _special_values(rng, shape):
    """Random-normal float32 with NaN, ±inf and ±0 sprinkled in."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    picks = rng.choice(flat.size, size=min(flat.size, 8), replace=False)
    flat[picks] = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, -0.0, np.nan, 1e30],
                           np.float32)[: len(picks)]
    return x


def _same_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.contiguous().view(torch.uint8), want.contiguous().view(torch.uint8))


def _combine_groups(grid):
    prog = dc.matmul_program(*grid, optimized=True)
    return [op for op in prog.ops if isinstance(op, opt.FusedCombine)]


# ------------------------------------------------------------ CPU: plain path
@pytest.mark.parametrize("km", LAYOUTS, ids=str)
def test_reduce_rounds_plain_is_np_allreduce(km):
    p = dc.allreduce_program(DeviceLayout(D3(*km)), optimized=True)
    x = _special_values(np.random.default_rng(0), (p.n, 7))
    g, m = opt.stacked_combine_tables(p)
    got = cf.reduce_rounds(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(m))
    np.testing.assert_array_equal(got.numpy(), opt.np_allreduce(x, p))


@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_combine_rows_plain_is_stage_order_fold(grid):
    rng = np.random.default_rng(1)
    for op in _combine_groups(grid):
        val = _special_values(rng, (op.gather.shape[1], 5))
        want = np.zeros_like(val)
        with np.errstate(invalid="ignore"):  # inf + -inf is NaN on both sides
            for g, m in zip(op.gather, op.mask):
                want[m] = want[m] + val[g[m]]
        got = cf.combine_rows(torch.from_numpy(val), torch.from_numpy(op.gather),
                              torch.from_numpy(op.mask))
        np.testing.assert_array_equal(got.numpy(), want)


def test_block_matmul_plain_keeps_dtype_and_is_exact_on_integers():
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.integers(-4, 5, (3, 5, 6)).astype(np.float32))
    b = torch.from_numpy(rng.integers(-4, 5, (3, 6, 4)).astype(np.float32))
    np.testing.assert_array_equal(block_matmul(a, b).numpy(),
                                  np.einsum("nab,nbc->nac", a.numpy(), b.numpy()))
    assert block_matmul(a.bfloat16(), b.bfloat16()).dtype == torch.bfloat16


@pytest.mark.parametrize("n,features,slab,block_f", [
    (64, 6553600, 16384, 256), (256, 262144, 16384, 64), (4, 3, 16384, 4),
    (16, 1, 16384, 1), (16384, 9, 16384, 1), (3, 100, 16, 4)])
def test_column_tile_fits_the_slab(n, features, slab, block_f):
    shift = cf.column_shift(n, features, slab)
    assert 1 << shift == block_f and n * block_f <= slab


def test_column_tile_refuses_more_rows_than_the_slab():
    with pytest.raises(ValueError, match="slab"):
        cf.column_shift(16385, 4, 16384)


@pytest.mark.parametrize("wrapper", ["reduce_rounds", "combine_rows", "block_matmul"])
def test_wrappers_refuse_devices_without_a_kernel(wrapper):
    """No silent fallback: only CPU tensors take the plain version; a tensor
    on any device without the kernel is refused before anything runs."""
    x = torch.empty((4, 4), device="meta")
    g = torch.empty((1, 1, 4), dtype=torch.int32, device="meta")
    m = torch.empty((1, 1, 4), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        if wrapper == "reduce_rounds":
            cf.reduce_rounds(x, g, m)
        elif wrapper == "combine_rows":
            cf.combine_rows(x, g[0], m[0])
        else:
            block_matmul(x[None], x[None])


@pytest.mark.parametrize("km", LAYOUTS + [(1, 2)], ids=str)
def test_backend_cpu_path_matches_reference(km):
    """All four kinds through cuda_fused(device='cpu'), plain and optimized,
    bit-exact with the NumPy reference on integer-valued float32."""
    layout = DeviceLayout(D3(*km))
    be = cf.CudaFusedBackend(device="cpu")
    rng = np.random.default_rng(3)
    n = layout.n
    x = rng.integers(-4, 5, (n, n, 3)).astype(np.float32)
    y = rng.integers(-4, 5, (n, 6)).astype(np.float32)
    for optimized in (False, True):
        p = dc.alltoall_program(layout, optimized=optimized)
        np.testing.assert_array_equal(be.run_alltoall(x, p).numpy(), REF.run_alltoall(x, p))
        p = dc.allreduce_program(layout, optimized=optimized)
        np.testing.assert_array_equal(be.run_allreduce(y, p).numpy(), REF.run_allreduce(y, p))
        p = dc.broadcast_program(layout, n - 1, optimized=optimized)
        np.testing.assert_array_equal(be.run_broadcast(y, p).numpy(), REF.run_broadcast(y, p))


@pytest.mark.parametrize("grid,X", [((1, 2), 4), ((2, 2), 2), ((1, 3), 3)], ids=str)
def test_backend_cpu_matmul_is_exact(grid, X):
    be = cf.CudaFusedBackend(device="cpu")
    rng = np.random.default_rng(4)
    N = mm.MatmulGrid(*grid).n * X
    B = rng.integers(-4, 5, (N, N)).astype(np.float32)
    A = rng.integers(-4, 5, (N, N)).astype(np.float32)
    for optimized in (False, True):
        got = be.run_matmul(B, A, dc.matmul_program(*grid, optimized=optimized)).numpy()
        np.testing.assert_array_equal(got, B @ A)


def test_backend_checks_the_device_axis():
    be = cf.CudaFusedBackend(device="cpu")
    p = dc.allreduce_program(DeviceLayout(D3(2, 2)))
    with pytest.raises(ValueError, match="leading dim"):
        be.run_allreduce(np.zeros((p.n + 1, 2), np.float32), p)
    with pytest.raises(ValueError, match="expected 'alltoall'"):
        be.run_alltoall(np.zeros((p.n, p.n), np.float32), p)


def test_flash_attention_grad_guard():
    """K4 has no backward: its guard refuses operands that need a gradient
    while autograd records, and lets everything else through. On CPU
    tensors the wrapper takes the plain version, which autograd
    differentiates."""
    q = torch.randn(1, 8, 2, 64, requires_grad=True)
    k, v = torch.randn(1, 8, 1, 64), torch.randn(1, 8, 1, 64)
    for args in ((q, k, v), (k.expand(1, 8, 2, 64), q, v), (q.detach(), k, q)):
        with pytest.raises(RuntimeError, match="no backward"):
            refuse_grad(*args)
    refuse_grad(q.detach(), k, v)
    with torch.no_grad():
        refuse_grad(q, k, v)
    before = flash_attention.launches
    flash_attention(q, k, v).sum().backward()
    assert q.grad is not None and bool(q.grad.abs().sum() > 0)
    assert flash_attention.launches == before


# ---------------------------------------------- CPU: K1/K2's two bodies' rules
STAGED_CASES = [  # (dtype, n, F, R, k, acc, aligned) -> body
    ((torch.float32, 64, 6553600, 6, 1, False, True), "staged"),   # K1 at the main shape
    ((torch.bfloat16, 64, 6553600, 6, 1, False, True), "staged"),
    ((torch.float32, 256, 262144, 1, 5, True, True), "staged"),    # K2 with acc at X = 512
    ((torch.bfloat16, 256, 262144, 1, 4, True, True), "staged"),
    ((torch.float32, 1, 4, 8, 5, False, True), "staged"),          # one row, one vector
    ((torch.float32, 1024, 4, 1, 1, False, True), "staged"),       # the most rows a tile holds
    ((torch.float32, 1025, 4, 1, 1, False, True), "slab"),
    ((torch.bfloat16, 1024, 8, 1, 1, False, True), "staged"),
    ((torch.bfloat16, 1025, 8, 1, 1, False, True), "slab"),
    ((torch.float32, 301, 1000, 2, 3, False, True), "staged"),     # two TMA boxes of 152 rows
    ((torch.float32, 256, 9, 1, 5, True, True), "slab"),           # X = 3: rows of 36 bytes
    ((torch.float32, 256, 4, 1, 5, True, True), "staged"),         # X = 2: one vector a row
    ((torch.bfloat16, 256, 4, 1, 5, False, True), "slab"),         # 8 bytes a row
    ((torch.float32, 64, 1000, 6, 1, False, False), "slab"),       # a base off 16 bytes
    ((torch.float32, 512, 1024, 25, 1, False, True), "staged"),    # a big table: smaller tile
    ((torch.float32, 1024, 1024, 40, 1, False, True), "slab"),     # a table past the memory
]


@pytest.mark.parametrize("case,body", STAGED_CASES, ids=str)
def test_reduce_body_for_and_stage_tile(case, body):
    """Which shapes take the staged body, and that its tile and stages fit:
    whole 16-byte vectors, at most a TMA box wide and STAGED_TILE_BYTES of
    values, no wider than the buffer needs, 2..STAGED_MAX_STAGES stages,
    and shared memory within a block's share."""
    dtype, n, F, R, k, acc, aligned = case
    assert cf.body_for(dtype, n, F, R, k, acc, aligned) == body
    esize = dtype.itemsize
    tile = cf.stage_tile(n, F, esize, R, k, acc)
    if body == "slab" and aligned:
        assert tile is None
        return
    shift, stages = tile
    block_f = 1 << shift
    assert 16 <= block_f * esize and block_f <= cf.STAGED_BOX
    assert n * block_f * esize <= cf.STAGED_TILE_BYTES
    assert block_f // 2 * esize < 16 or block_f // 2 < F
    assert 2 <= stages <= cf.STAGED_MAX_STAGES
    assert cf.staged_smem(n, shift, esize, R, k, stages, acc) <= cf.STAGED_SMEM_BYTES


def test_stage_tile_takes_the_widest_tile_and_the_most_stages():
    assert cf.stage_tile(64, 6553600, 4, 6, 1) == (6, 4)  # 16 KiB tiles, 4 stages, 2 scratch
    assert cf.stage_tile(64, 6553600, 2, 6, 1) == (7, 4)  # bf16: twice the columns
    assert cf.stage_tile(256, 262144, 4, 1, 5, acc=True) == (4, 3)  # 32 KiB stages
    assert cf.stage_tile(256, 262144, 4, 1, 5) == (4, 4)
    assert cf.stage_tile(512, 1024, 4, 25, 1) == (2, 4)  # 50 KiB of table: 8 KiB tiles
    assert cf.stage_tile(64, 6553600, 4, 6, 1, smem=60_000) == (5, 4)  # less memory: halve
    assert cf.stage_tile(4, 100, 4, 1, 1) == (7, 4)  # no wider than the buffer needs
    # 301 rows come in two TMA boxes of 152 (a multiple of 8: each lands
    # 128-byte aligned): 304 rows of 16 bytes, beside barriers, a zero row
    # and the table (to 128)
    assert cf.staged_smem(301, 2, 4, 1, 1, 1, False) == 1408 + 304 * 16


@pytest.mark.parametrize("km", LAYOUTS, ids=str)
def test_packed_tables_replay_like_the_unpacked(km):
    """One int32 an entry (the row, or -1 where the mask is false) replays
    bit for bit as the (gather, mask) pair does, special values included."""
    p = dc.allreduce_program(DeviceLayout(D3(*km)), optimized=True)
    g, m = opt.stacked_combine_tables(p)
    packed = cf.pack_tables(g, m)
    assert packed.dtype == np.int32 and packed.shape == g.shape
    assert np.array_equal(packed >= 0, m) and np.array_equal(packed[m], g[m])
    assert torch.equal(cf.pack_tables(torch.from_numpy(g), torch.from_numpy(m)),
                       torch.from_numpy(packed))
    x = torch.from_numpy(_special_values(np.random.default_rng(12), (p.n, 9)))
    _same_bits(cf.replay_packed(x, torch.from_numpy(packed)),
               cf.reduce_rounds(x, torch.from_numpy(g), torch.from_numpy(m)))


@pytest.mark.parametrize("grid", GRIDS, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_combine_rows_plain_adds_acc(grid, dtype):
    """``combine_rows(..., acc=)`` on the CPU is ``acc + fold`` bit for bit,
    for a non-zero acc, and the packed replay with acc agrees."""
    rng = np.random.default_rng(13)
    for op in _combine_groups(grid):
        n = op.gather.shape[1]
        val = torch.from_numpy(_special_values(rng, (n, 6))).to(dtype)
        acc = torch.from_numpy(_special_values(rng, (n, 6))).to(dtype)
        g, m = torch.from_numpy(op.gather), torch.from_numpy(op.mask)
        got = cf.combine_rows(val, g, m, acc=acc)
        _same_bits(got, acc + cf.combine_rows(val, g, m))
        _same_bits(got, cf.replay_packed(val, cf.pack_tables(g, m)[None], self_add=False,
                                         acc=acc))
        with pytest.raises(ValueError, match="acc"):
            cf.combine_rows(val, g, m, acc=acc[:, :3])


@pytest.mark.parametrize("grid,X", [((1, 2), 4), ((2, 2), 2), ((1, 3), 3)], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_backend_cpu_matmul_matches_the_plain_replay(grid, X, dtype):
    """run_matmul on the CPU, its combine hook now ``combine_rows(acc=)``,
    against the optimizer's plain §2 replay on random normals, bit for bit."""
    be = cf.CudaFusedBackend(device="cpu")
    prog = dc.matmul_program(*grid, optimized=True)
    rng = np.random.default_rng(14)
    N = mm.MatmulGrid(*grid).n * X
    B, A = (torch.from_numpy(rng.standard_normal((N, N)).astype(np.float32)).to(dtype)
            for _ in range(2))
    want = opt.torch_gather_blocks(opt.torch_matmul_blocks(prog, torch.device("cpu"))(
        opt.torch_scatter_blocks(B, grid), opt.torch_scatter_blocks(A, grid)), grid)
    _same_bits(be.run_matmul(B, A, prog), want)


# ------------------------------------------------------------- card: kernels
@pytest.mark.gpu
@pytest.mark.parametrize("km", LAYOUTS, ids=str)
@pytest.mark.parametrize("F", [1, 37, 1000, 4097])
def test_reduce_rounds_kernel_bit_exact(cuda, km, F):
    p = dc.allreduce_program(DeviceLayout(D3(*km)), optimized=True)
    t = opt.to_device_tables(opt.allreduce_tables(p), cuda)
    x = torch.from_numpy(_special_values(np.random.default_rng(F), (p.n, F))).to(cuda)
    before = cf.reduce_rounds.launches
    got = cf.reduce_rounds(x, t["gather"], t["mask"])
    torch.cuda.synchronize()
    assert cf.reduce_rounds.launches == before + 1
    want = cf._reduce_rounds_plain(x, t["gather"], t["mask"])
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("grid", GRIDS + [(4, 4)], ids=str)
@pytest.mark.parametrize("X", [2, 3, 33])
def test_combine_rows_kernel_bit_exact(cuda, grid, X):
    rng = np.random.default_rng(X)
    for op in _combine_groups(grid):
        t = opt.to_device_tables({"gather": op.gather, "mask": op.mask}, cuda)
        val = torch.from_numpy(_special_values(rng, (op.gather.shape[1], X * X))).to(cuda)
        got = cf.combine_rows(val, t["gather"], t["mask"])
        want = cf._combine_rows_plain(val, t["gather"], t["mask"])
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("km", LAYOUTS, ids=str)
@pytest.mark.parametrize("F", [1, 37, 4097])
def test_reduce_rounds_kernel_bit_exact_in_bf16(cuda, km, F):
    """Each bf16 add rounded at once, as the plain torch replay does on the
    card: the same bits, NaN, ±inf and ±0 included."""
    p = dc.allreduce_program(DeviceLayout(D3(*km)), optimized=True)
    t = opt.to_device_tables(opt.allreduce_tables(p), cuda)
    x = torch.from_numpy(_special_values(np.random.default_rng(F), (p.n, F))).to(cuda, torch.bfloat16)
    before = cf.reduce_rounds.launches
    got = cf.reduce_rounds(x, t["gather"], t["mask"])
    torch.cuda.synchronize()
    assert cf.reduce_rounds.launches == before + 1
    _same_bits(got, cf._reduce_rounds_plain(x, t["gather"], t["mask"]))


@pytest.mark.gpu
@pytest.mark.parametrize("grid", GRIDS + [(4, 4)], ids=str)
@pytest.mark.parametrize("X", [3, 33])
def test_combine_rows_kernel_bit_exact_in_bf16(cuda, grid, X):
    rng = np.random.default_rng(X)
    for op in _combine_groups(grid):
        t = opt.to_device_tables({"gather": op.gather, "mask": op.mask}, cuda)
        val = torch.from_numpy(_special_values(rng, (op.gather.shape[1], X * X))).to(
            cuda, torch.bfloat16)
        _same_bits(cf.combine_rows(val, t["gather"], t["mask"]),
                   cf._combine_rows_plain(val, t["gather"], t["mask"]))


def _random_tables(rng, R, k, n, device):
    """Random (R, k, n) gather and mask tables, about a third of the mask false."""
    g = torch.from_numpy(rng.integers(0, n, (R, k, n)).astype(np.int32)).to(device)
    m = torch.from_numpy(rng.random((R, k, n)) < 0.67).to(device)
    return g, m


def _each_body(dtype, n, F, R, k, acc):
    """The bodies that take these operands: slab always, staged where its rule does."""
    staged = cf.body_for(dtype, n, F, R, k, acc) == "staged"
    return ["slab", "staged"] if staged else ["slab"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("n", [1, 8, 64, 256, 301])
@pytest.mark.parametrize("R,k", [(1, 1), (2, 3), (5, 2), (8, 5)], ids=str)
@pytest.mark.parametrize("F", [8, 40, 1000, 4104, 3])
def test_reduce_rounds_each_body_bit_exact(cuda, dtype, n, R, k, F):
    """K1's two bodies against the plain replay on random tables: ragged F
    (off every tile width; 3 columns only the slab body takes), n from 1
    to 256 and 301 (two TMA boxes of 152 rows), up to 8 rounds of 5 rows,
    NaN, ±inf and ±0 planted. Same bits, one launch of the body asked for."""
    rng = np.random.default_rng(n * 1000 + R * 10 + k)
    g, m = _random_tables(rng, R, k, n, cuda)
    x = torch.from_numpy(_special_values(rng, (n, F))).to(cuda, dtype)
    want = cf._reduce_rounds_plain(x, g, m)
    for body in _each_body(dtype, n, F, R, k, False):
        before = dict(cf.reduce_rounds.body_launches)
        got = cf.reduce_rounds(x, g, m, body=body)
        torch.cuda.synchronize()
        _same_bits(got, want)
        assert cf.reduce_rounds.body_launches[body] == before[body] + 1
    _same_bits(cf.reduce_rounds(x, g, m, packed=cf.pack_tables(g, m)), want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("n", [1, 8, 64, 256])
@pytest.mark.parametrize("k", [1, 4, 5])
@pytest.mark.parametrize("F", [8, 72, 1000, 4104, 9])
def test_combine_rows_each_body_with_acc(cuda, dtype, n, k, F):
    """K2's two bodies, with and without acc, against ``acc + fold`` and the
    fold: random tables, a random non-zero acc, special values in both."""
    rng = np.random.default_rng(n * 100 + k)
    g, m = _random_tables(rng, 1, k, n, cuda)
    g, m = g[0], m[0]
    val = torch.from_numpy(_special_values(rng, (n, F))).to(cuda, dtype)
    acc = torch.from_numpy(_special_values(rng, (n, F))).to(cuda, dtype)
    fold = cf._combine_rows_plain(val, g, m)
    for body in _each_body(dtype, n, F, 1, k, True):
        before = (cf.combine_rows.acc_launches, cf.combine_rows.body_launches[body])
        _same_bits(cf.combine_rows(val, g, m, acc=acc, body=body), acc + fold)
        _same_bits(cf.combine_rows(val, g, m, body=body), fold)
        torch.cuda.synchronize()
        assert (cf.combine_rows.acc_launches, cf.combine_rows.body_launches[body]) == \
            (before[0] + 1, before[1] + 2)


@pytest.mark.gpu
def test_staged_limits_are_the_kernels(cuda):
    """The tile chooser's limits are the kernel's on this card: otherwise it
    would pick tiles the kernel refuses, or leave shared memory unused."""
    import ctypes

    from repro_torch.kernels import build

    got = [ctypes.c_int() for _ in range(3)]
    build.load("reduce_rounds").reduce_rounds_staged_limits(*map(ctypes.byref, got))
    assert [v.value for v in got] == [cf.STAGED_TILE_BYTES, cf.STAGED_MAX_STAGES,
                                      cf.STAGED_SMEM_BYTES]


@pytest.mark.gpu
def test_staged_body_refuses_what_it_does_not_take(cuda):
    """No quiet fallback: a forced staged body on rows of 36 bytes, on a base
    off 16 bytes, or past the rows a tile holds raises before a launch; the
    rule sends those shapes to the slab body."""
    g = torch.zeros((1, 1, 4), dtype=torch.int32, device=cuda)
    m = torch.ones((1, 1, 4), dtype=torch.bool, device=cuda)
    x = torch.ones((4, 9), device=cuda)
    with pytest.raises(ValueError, match="staged"):
        cf.reduce_rounds(x, g, m, body="staged")
    x = torch.ones(4 * 8 + 1, device=cuda)[1:].view(4, 8)  # 4 bytes off 16
    assert x.is_contiguous() and x.data_ptr() % 16
    with pytest.raises(ValueError, match="16 bytes"):
        cf.reduce_rounds(x, g, m, body="staged")
    _same_bits(cf.reduce_rounds(x, g, m), cf._reduce_rounds_plain(x, g, m))
    g = torch.zeros((1, 1, 4096), dtype=torch.int32, device=cuda)
    m = torch.ones((1, 1, 4096), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="staged"):
        cf.reduce_rounds(torch.ones((4096, 4), device=cuda), g, m, body="staged")


@pytest.mark.gpu
def test_reduce_kernels_refuse_other_dtypes(cuda):
    p = dc.allreduce_program(DeviceLayout(D3(2, 2)), optimized=True)
    t = opt.to_device_tables(opt.allreduce_tables(p), cuda)
    with pytest.raises(TypeError, match="float32"):
        cf.reduce_rounds(torch.zeros((p.n, 4), dtype=torch.float64, device=cuda),
                         t["gather"], t["mask"])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(5, 2, 2, 2), (7, 3, 3, 3), (4, 4, 4, 4), (3, 130, 67, 129),
                                   (2, 128, 128, 128), (1, 256, 512, 128)], ids=str)
def test_block_matmul_kernel_exact_on_integers(cuda, shape):
    batch, m, k, n = shape
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.integers(-4, 5, (batch, m, k)).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.integers(-4, 5, (batch, k, n)).astype(np.float32)).to(cuda)
    got = block_matmul(a, b)
    np.testing.assert_array_equal(got.cpu().numpy(), block_matmul_ref(a, b).cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", [(128, 128, 128), (256, 128, 512), (128, 384, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_block_matmul_kernel_tolerance(cuda, m, n, k, dtype):
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.standard_normal((2, m, k)).astype(np.float32)).to(cuda, dtype)
    b = torch.from_numpy(rng.standard_normal((2, k, n)).astype(np.float32)).to(cuda, dtype)
    got = block_matmul(a, b)
    assert got.dtype == dtype
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               block_matmul_ref(a, b).float().cpu().numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,body", [
    ((3, 2, 2, 2), "simt"), ((3, 3, 3, 3), "simt"), ((3, 4, 4, 4), "tf32x3"),
    ((2, 512, 512, 512), "tf32x3"), ((2, 130, 68, 132), "tf32x3"), ((2, 200, 36, 260), "tf32x3"),
    ((2, 130, 67, 129), "simt"), ((1, 64, 100, 1000), "tf32x3"), ((2, 5, 0, 8), None),
], ids=str)
def test_block_matmul_each_body_on_card(cuda, shape, body):
    """Shapes that take each body (X = 2, 3 and a K or N off a multiple of 4
    the FFMA body; X = 4, 512 and M, N, K off the 128 x 128 x 32 tile the
    tf32x3 body), counted where the wrapper launches: exact on integers in
    [-4, 4], within rtol = atol = 2e-4 of the float32 product on normals.
    With no depth (K = 0) the product is zeros and nothing is launched."""
    batch, m, k, n = shape
    if body is not None:
        assert matmul_body(torch.float32, m, n, k) == body
    block_matmul.body_launches = dict.fromkeys(block_matmul.body_launches, 0)
    rng = np.random.default_rng(8)
    ints = [torch.from_numpy(rng.integers(-4, 5, s).astype(np.float32)).to(cuda)
            for s in [(batch, m, k), (batch, k, n)]]
    np.testing.assert_array_equal(block_matmul(*ints).cpu().numpy(),
                                  block_matmul_ref(*ints).cpu().numpy())
    normals = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)
               for s in [(batch, m, k), (batch, k, n)]]
    np.testing.assert_allclose(block_matmul(*normals).cpu().numpy(),
                               block_matmul_ref(*normals).cpu().numpy(), rtol=2e-4, atol=2e-4)
    assert block_matmul.body_launches == {name: 2 if name == body else 0
                                          for name in block_matmul.body_launches}


@pytest.mark.gpu
@pytest.mark.parametrize("km", [(2, 2), (4, 2)], ids=str)
def test_backend_on_card_matches_reference(cuda, km):
    layout = DeviceLayout(D3(*km))
    be = cf.CudaFusedBackend()
    rng = np.random.default_rng(7)
    n = layout.n
    x = rng.integers(-4, 5, (n, n, 3)).astype(np.float32)
    y = rng.integers(-4, 5, (n, 6)).astype(np.float32)
    p = dc.alltoall_program(layout, optimized=True)
    np.testing.assert_array_equal(be.run_alltoall(x, p).cpu().numpy(), REF.run_alltoall(x, p))
    p = dc.allreduce_program(layout, optimized=True)
    np.testing.assert_array_equal(be.run_allreduce(y, p).cpu().numpy(), REF.run_allreduce(y, p))
    p = dc.broadcast_program(layout, 1, optimized=True)
    np.testing.assert_array_equal(be.run_broadcast(y, p).cpu().numpy(), REF.run_broadcast(y, p))
    grid, X = (2, 2), 3
    N = mm.MatmulGrid(*grid).n * X
    B = rng.integers(-4, 5, (N, N)).astype(np.float32)
    A = rng.integers(-4, 5, (N, N)).astype(np.float32)
    before = (cf.combine_rows.launches, block_matmul.launches)
    got = be.run_matmul(B, A, dc.matmul_program(*grid)).cpu().numpy()
    np.testing.assert_array_equal(got, B @ A)
    assert cf.combine_rows.launches > before[0] and block_matmul.launches > before[1]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal,window", [
    (2, 128, 128, 4, 4, 64, True, None),
    (2, 128, 256, 4, 2, 64, False, None),
    (2, 256, 256, 8, 1, 64, True, 64),
    (1, 100, 130, 8, 2, 96, True, 32),
    (2, 192, 192, 4, 4, 96, True, None),
    (1, 130, 70, 4, 1, 128, True, 32),
    (3, 1, 200, 4, 4, 64, False, None),
], ids=str)
def test_flash_attention_kernel_matches_plain(cuda, dtype, b, sq, sk, hq, hkv, d, causal,
                                               window):
    """K4 against its plain version on the card, in the (B, S, H, D) layout
    with grouped KV heads, head_dim 64, 96 (Phi-3-mini) and 128, ragged
    lengths, Sq != Sk and windows that leave rows with no key. float32
    within 2e-4 (the sums run in another order; the kernel's hi/lo bf16
    split keeps about 16 bits); bf16 within rtol = atol = 1e-2 and a
    relative rms error of 1e-2 (the kernel and the plain version round p
    and the output at other points: about one bf16 step of 2^-8)."""
    rng = np.random.default_rng(10)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda, dtype)
               for s in [(b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d)])
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1 and got.dtype == dtype
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    tol = 1e-2 if dtype == torch.bfloat16 else 2e-4
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=tol, atol=tol)
    assert float((got.float() - want.float()).norm() / want.float().norm()) <= 1e-2
    # head 0 alone, through strided views, is head 0 of the group bit for bit
    head0 = flash_attention(q[:, :, :1], k[:, :, :1], v[:, :, :1], causal=causal, window=window)
    np.testing.assert_array_equal(head0.float().cpu().numpy(), got[:, :, :1].float().cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal,window", [
    (1, 300, 300, 4, 2, 128, True, None),    # Sq, Sk off the 128-row tile, D = 128
    (2, 257, 390, 2, 2, 96, False, None),    # D = 96: the second column block zero-filled
    (1, 700, 700, 2, 1, 128, True, 200),
    (1, 1, 300, 4, 4, 96, True, None),       # one query row
    (1, 1100, 1100, 2, 1, 64, True, 300),    # a band: whole tiles inside, edges masked
    (1, 1100, 1100, 2, 1, 64, False, 300),   # the window alone
], ids=str)
def test_flash_attention_wgmma_body_edges(cuda, b, sq, sk, hq, hkv, d, causal, window):
    """The bf16 wgmma body at the edges of its 128-row and 128-key tiles,
    head_dim 96 and 128, and windows whose band leaves whole key tiles
    unmasked (the mask is skipped there) and others partly masked; within
    the bf16 bound of the other K4 tests. No key at all gives zeros."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda, torch.bfloat16)
               for s in [(b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d)])
    want = flash_attention_plain(q, k, v, causal=causal, window=window).float()
    flash_attention.body_launches = dict.fromkeys(flash_attention.body_launches, 0)
    got = flash_attention(q, k, v, causal=causal, window=window).float()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-2, atol=1e-2)
    assert float((got - want).norm() / want.norm()) <= 1e-2
    none = flash_attention(q, k[:, :0], v[:, :0], causal=causal, window=window)
    assert none.shape == q.shape and not bool(none.any())
    assert flash_attention.body_launches == {"mma_sync": 0, "wgmma": 1}


@pytest.mark.gpu
def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((1, 64, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(x, x, x)
    x = torch.zeros((1, 64, 2, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(x, x, x)
    x = torch.zeros((1, 64, 2, 72), device=cuda)[..., 2:66]  # rows 8 bytes off 16
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(x, x, x)


@pytest.mark.gpu
def test_flash_attention_kernel_refuses_autograd(cuda):
    """A backward through K4 on the card raises before the launch instead
    of leaving q, k and v without a gradient; under no_grad the kernel
    runs."""
    q = torch.randn(1, 128, 4, 64, device=cuda).to(torch.bfloat16).requires_grad_()
    k, v = (torch.randn(1, 128, 2, 64, device=cuda).to(torch.bfloat16) for _ in range(2))
    before = flash_attention.launches
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, v).float().sum().backward()
    assert flash_attention.launches == before and q.grad is None
    with torch.no_grad():
        out = flash_attention(q, k, v)
    assert flash_attention.launches == before + 1 and not out.requires_grad


# ------------------------------------------------- card: K5, the ring exchange
def _k5_rank(rank, group, layout):
    """One rank of the K5 check: per dtype and shape, three calls with fresh
    data through ``allreduce_shard`` (K5) against ``allreduce_shard_plain``
    on host copies (the plain exchange through gloo). Random-normal values
    with ±0.0 sprinkled in, no NaN or inf: a NaN's payload bits after an
    add differ between the host and the card."""
    from repro_torch.launch.mesh import rank_device

    dev = rank_device(rank)
    prog = dc.allreduce_program(layout)
    be = cf.CudaFusedBackend()
    rng = np.random.default_rng(rank)
    same, launches = [], []
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((37, 29), (4101,), (64, 1024)):
            for _ in range(3):
                x = rng.standard_normal(shape).astype(np.float32)
                x.reshape(-1)[rng.choice(x.size, 6, replace=False)] = [0.0, -0.0] * 3
                x = torch.from_numpy(x).to(dtype)
                before = (cf.ring_put.launches, cf.ring_signal.launches,
                          cf.ring_wait_add.launches)
                got = be.allreduce_shard(x.to(dev), group, prog).cpu()
                launches.append((cf.ring_put.launches - before[0],
                                 cf.ring_signal.launches - before[1],
                                 cf.ring_wait_add.launches - before[2]))
                want = cf.allreduce_shard_plain(x, group, prog)
                same.append(bool(torch.equal(got.view(torch.uint8), want.view(torch.uint8))))
    cf.close_ring_windows(group)
    return same, launches, len(prog.comm_stages)


@pytest.mark.gpu
def test_ring_exchange_kernel_bit_exact_with_its_plain_version(cuda):
    """K5 on 4 ranks that share card 0 (a gloo group; the library is built
    once here, before the ranks start), bit for bit against its plain
    version, float32 and bf16, one launch of each K5 kernel per round."""
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import spawn

    build.build_all(("ring_exchange",))
    for same, launches, rounds in spawn(_k5_rank, 4, device="cuda"):
        assert all(same)
        assert set(launches) == {(rounds, rounds, rounds)}
