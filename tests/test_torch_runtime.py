"""Execution parity of the port with the JAX package, on the CPU.

The same inputs, made by numpy from a seed, go through the JAX package's
backends (``pallas_fused`` with its Pallas kernels in interpret mode, and
the NumPy ``reference``) and through the port's ``cuda_fused`` backend on
its CPU path, where every kernel wrapper takes its plain torch version.
Integer-valued float32 makes every comparison bit-exact, as the backend
contract is. The port's replays are also fed the JAX package's own fused
tables through ``to_device_tables``, so an execution drift fails here even
where the derivation (``test_torch_core.py``) agrees.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.dist import collectives as j_dc
from repro.dist.mesh import DeviceLayout as JLayout
from repro.core.topology import D3 as JD3
from repro.core.matmul import MatmulGrid
from repro.kernels.block_matmul.block_matmul import block_matmul as j_block_matmul
from repro.kernels.block_matmul.ops import batched_matmul as j_batched_matmul
from repro.runtime import optimize as j_opt
from repro.runtime.backends.pallas_fused import PallasFusedBackend
from repro.runtime.backends.reference import NumpyReferenceBackend as JRef
from repro.runtime.backends.sendrecv import SendRecvBackend as JSendRecv

from repro_torch.core.topology import D3 as TD3
from repro_torch.dist import collectives as t_dc
from repro_torch.dist.mesh import DeviceLayout as TLayout
from repro_torch.kernels.block_matmul import ops as t_ops
from repro_torch.runtime import optimize as t_opt
from repro_torch.runtime.backends import available_backends, get_backend
from repro_torch.runtime.backends.cuda_fused import CudaFusedBackend
from repro_torch.runtime.backends.reference import NumpyReferenceBackend as TRef
from repro_torch.runtime.backends.sendrecv import SendRecvBackend

PAL = PallasFusedBackend(interpret=True)
JREF = JRef()
TREF = TRef()
CPU = CudaFusedBackend(device="cpu")
LAYOUTS = [(2, 2), (4, 2)]
GRIDS = [((1, 2), 4), ((2, 2), 2)]


def programs(km, optimized):
    jl, tl = JLayout(JD3(*km)), TLayout(TD3(*km))
    return {
        "alltoall": (j_dc.alltoall_program(jl, optimized=optimized),
                     t_dc.alltoall_program(tl, optimized=optimized)),
        "allreduce": (j_dc.allreduce_program(jl, optimized=optimized),
                      t_dc.allreduce_program(tl, optimized=optimized)),
        "broadcast": (j_dc.broadcast_program(jl, 1, optimized=optimized),
                      t_dc.broadcast_program(tl, 1, optimized=optimized)),
    }


def inputs(kind, n, seed):
    rng = np.random.default_rng(seed)
    shape = (n, n, 3) if kind == "alltoall" else (n, 5)
    return rng.integers(-4, 5, shape).astype(np.float32)


def matrices(grid, X, seed):
    rng = np.random.default_rng(seed)
    N = MatmulGrid(*grid).n * X
    return tuple(rng.integers(-4, 5, (N, N)).astype(np.float32) for _ in range(2))


def assert_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), np.ascontiguousarray(want).view(np.uint8))


def jax_matmul_recipe(jo):
    """The JAX package's fused §2 ops as the port's replay recipe."""
    recipe = []
    for op in jo.ops:
        kind = type(op).__name__
        if kind == "FusedLocal":
            recipe.append(("local", op.fn, {"mask": op.mask} if op.fn == "store_c" else {}))
        else:
            recipe.append(("select" if kind == "FusedSelect" else "combine", None,
                           {"gather": op.gather, "mask": op.mask}))
    return recipe


# ------------------------------------------------------------- registry
def test_registry_holds_reference_and_cuda_fused():
    assert available_backends() == ("reference", "cuda_fused", "sendrecv", "torch_dist")
    assert isinstance(get_backend("cuda_fused", device="cpu"), CudaFusedBackend)
    assert isinstance(get_backend("reference"), TRef)
    assert isinstance(get_backend("sendrecv"), SendRecvBackend)
    with pytest.raises(ValueError, match="reference, cuda_fused, sendrecv, torch_dist"):
        get_backend("pallas_fused")


# -------------------------------------------------------- NumPy replays
@pytest.mark.parametrize("km", LAYOUTS, ids=str)
def test_np_replays_bit_equal(km):
    for kind, (jo, to) in programs(km, optimized=True).items():
        x = inputs(kind, jo.n, 0)
        if kind == "allreduce":
            x = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
        assert_bits(getattr(t_opt, f"np_{kind}")(x, to), getattr(j_opt, f"np_{kind}")(x, jo))


@pytest.mark.parametrize("grid,X", GRIDS, ids=str)
def test_np_matmul_blocks_bit_equal(grid, X):
    jo, to = j_dc.matmul_program(*grid, optimized=True), t_dc.matmul_program(*grid, optimized=True)
    rng = np.random.default_rng(2)
    b, a = (rng.standard_normal((jo.n, X, X)).astype(np.float32) for _ in range(2))
    assert_bits(t_opt.np_matmul_blocks(b, a, to), j_opt.np_matmul_blocks(b, a, jo))


@pytest.mark.parametrize("km", LAYOUTS, ids=str)
def test_reference_backends_bit_equal(km):
    for optimized in (False, True):
        for kind, (jp, tp) in programs(km, optimized).items():
            x = inputs(kind, jp.n, 3)
            assert_bits(getattr(TREF, f"run_{kind}")(x, tp), getattr(JREF, f"run_{kind}")(x, jp))
    jp, tp = programs(km, False)["alltoall"]
    x = inputs("alltoall", jp.n, 10)

    def compute(dst, chunks):
        return chunks * (dst + 1) - 1

    assert_bits(TREF.run_alltoall_compute(x, tp, compute), JREF.run_alltoall_compute(x, jp, compute))


# ------------------------------------------ sendrecv: the trace replayed
@pytest.mark.parametrize("km", LAYOUTS, ids=str)
@pytest.mark.parametrize("optimized", [False, True])
def test_sendrecv_replays_bit_equal(km, optimized):
    """The port's sendrecv backend, replaying each program's exported
    trace, against the port's reference and cuda_fused (CPU) and the JAX
    package's sendrecv, bit for bit."""
    sr, jsr = SendRecvBackend(), JSendRecv()
    for kind, (jp, tp) in programs(km, optimized).items():
        x = inputs(kind, jp.n, 5)
        got = getattr(sr, f"run_{kind}")(x, tp)
        assert_bits(got, getattr(TREF, f"run_{kind}")(x, tp))
        assert_bits(got, getattr(CPU, f"run_{kind}")(x, tp).numpy())
        assert_bits(got, getattr(jsr, f"run_{kind}")(x, jp))


@pytest.mark.parametrize("grid,X", GRIDS, ids=str)
@pytest.mark.parametrize("optimized", [False, True])
def test_sendrecv_matmul_bit_equal(grid, X, optimized):
    jp = j_dc.matmul_program(*grid, optimized=optimized)
    tp = t_dc.matmul_program(*grid, optimized=optimized)
    B, A = matrices(grid, X, 6)
    got = SendRecvBackend().run_matmul(B, A, tp)
    assert_bits(got, TREF.run_matmul(B, A, tp))
    assert_bits(got, CPU.run_matmul(B, A, tp).numpy())
    assert_bits(got, JSendRecv().run_matmul(B, A, jp))
    assert_bits(got, B @ A)


# ------------------------------------ the port's CPU path vs pallas_fused
@pytest.mark.parametrize("km", LAYOUTS, ids=str)
@pytest.mark.parametrize("optimized", [False, True])
def test_cuda_fused_cpu_path_matches_pallas_and_reference(km, optimized):
    for kind, (jp, tp) in programs(km, optimized).items():
        x = inputs(kind, jp.n, 4)
        got = getattr(CPU, f"run_{kind}")(x, tp).numpy()
        assert_bits(got, getattr(PAL, f"run_{kind}")(x, jp))
        assert_bits(got, getattr(JREF, f"run_{kind}")(x, jp))


@pytest.mark.parametrize("grid,X", GRIDS, ids=str)
@pytest.mark.parametrize("optimized", [False, True])
def test_cuda_fused_cpu_matmul_matches_pallas_and_reference(grid, X, optimized):
    B, A = matrices(grid, X, 5)
    jp = j_dc.matmul_program(*grid, optimized=optimized)
    got = CPU.run_matmul(B, A, t_dc.matmul_program(*grid, optimized=optimized)).numpy()
    assert_bits(got, PAL.run_matmul(B, A, jp))
    assert_bits(got, JREF.run_matmul(B, A, jp))
    assert_bits(got, B @ A)


def test_allreduce_random_normal_matches_pallas():
    """Not only integers: the stage-order fold makes random-normal float32
    bit-exact too."""
    jo, to = programs((4, 2), True)["allreduce"]
    x = np.random.default_rng(6).standard_normal((jo.n, 33)).astype(np.float32)
    assert_bits(CPU.run_allreduce(x, to).numpy(), PAL.run_allreduce(x, jo))


# -------------------------- the JAX package's tables through to_device_tables
@pytest.mark.parametrize("km", LAYOUTS, ids=str)
def test_to_device_tables_keeps_the_bits(km):
    for _, (jo, to) in programs(km, optimized=True).items():
        tables = {"alltoall": t_opt.alltoall_tables, "allreduce": t_opt.allreduce_tables,
                  "broadcast": t_opt.broadcast_tables}[to.kind](jo)
        for key, arr in t_opt.to_device_tables(tables, "cpu").items():
            assert_bits(arr.numpy(), tables[key])


@pytest.mark.parametrize("km", LAYOUTS, ids=str)
def test_replays_on_the_jax_package_tables(km):
    progs = programs(km, optimized=True)
    x = inputs("alltoall", progs["alltoall"][0].n, 7)
    (op,) = progs["alltoall"][0].ops
    t = t_opt.to_device_tables({"src": op.src, "dst": op.dst}, "cpu")
    assert_bits(t_opt.replay_alltoall(torch.from_numpy(x), t["src"], t["dst"]).numpy(),
                PAL.run_alltoall(x, progs["alltoall"][0]))

    jo = progs["allreduce"][0]
    x = inputs("allreduce", jo.n, 8)
    g, m = j_opt.stacked_combine_tables(jo)
    t = t_opt.to_device_tables({"gather": g, "mask": m}, "cpu")
    assert_bits(t_opt.replay_allreduce(torch.from_numpy(x), t["gather"], t["mask"]).numpy(),
                PAL.run_allreduce(x, jo))

    jo = progs["broadcast"][0]
    t = t_opt.to_device_tables({"gather": np.stack([op.gather for op in jo.ops]),
                                "mask": np.stack([op.mask for op in jo.ops])}, "cpu")
    got = t_opt.replay_broadcast(torch.from_numpy(x), t["gather"], t["mask"],
                                 [op.wave for op in jo.ops], waves=False)
    assert_bits(got.numpy(), PAL.run_broadcast(x, jo))


@pytest.mark.parametrize("grid,X", GRIDS, ids=str)
def test_matmul_replay_on_the_jax_package_tables(grid, X):
    jo = j_dc.matmul_program(*grid, optimized=True)
    rng = np.random.default_rng(9)
    b, a = (rng.integers(-4, 5, (jo.n, X, X)).astype(np.float32) for _ in range(2))
    recipe = [(kind, fn, t_opt.to_device_tables(tabs, "cpu"))
              for kind, fn, tabs in jax_matmul_recipe(jo)]
    got = t_opt.replay_matmul(recipe, torch.from_numpy(b), torch.from_numpy(a))
    assert_bits(got.numpy(), j_opt.jax_matmul_blocks(jo)(b, a))
    assert_bits(got.numpy(), JREF.matmul_blocks(b, a, jo))


@pytest.mark.parametrize("grid,X", GRIDS + [((1, 3), 3)], ids=str)
def test_block_scatter_gather_match_the_jax_helpers(grid, X):
    N = MatmulGrid(*grid).n * X
    mat = np.random.default_rng(11).standard_normal((N, N)).astype(np.float32)
    blocks = t_opt.torch_scatter_blocks(torch.from_numpy(mat), grid)
    assert blocks.is_contiguous()
    assert_bits(blocks.numpy(), j_opt.jax_scatter_blocks(mat, grid))
    assert_bits(t_opt.torch_gather_blocks(blocks, grid).numpy(), mat)


@pytest.mark.parametrize("axes", [(0,), (0, 1)], ids=str)
def test_guest_scatter_gather_match_the_jax_helpers(axes):
    """Programs whose ``active_devices`` name a guest's host slots: idle
    slots are zero-filled on the way in and dropped on the way out."""
    from repro.runtime.program import CollectiveProgram as JProgram
    from repro_torch.runtime.program import CollectiveProgram as TProgram

    active = (5, 1, 3, 7)
    jp, tp = (P("alltoall", 8, 0, (), active_devices=active) for P in (JProgram, TProgram))
    x = np.random.default_rng(12).standard_normal((4, 4, 2)).astype(np.float32)
    host = t_opt.torch_scatter_guest(torch.from_numpy(x), tp, axes=axes)
    assert_bits(host.numpy(), j_opt.jax_scatter_guest(x, jp, axes=axes))
    assert_bits(t_opt.torch_gather_guest(host, tp, axes=axes).numpy(), x)


# ---------------------------------------------------- block matmul oracle
@pytest.mark.parametrize("m,n,k", [(128, 128, 128), (256, 128, 512), (128, 384, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_matmul_plain_matches_pallas_interpret(m, n, k, dtype):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    want = j_block_matmul(jnp.asarray(a, dtype), jnp.asarray(b, dtype),
                          bm=128, bn=128, bk=128, interpret=True)
    got = t_ops.matmul(torch.from_numpy(a).to(getattr(torch, dtype)),
                       torch.from_numpy(b).to(getattr(torch, dtype)))
    assert str(got.dtype) == f"torch.{dtype}"
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_batched_matmul_plain_matches_vmapped_pallas():
    rng = np.random.default_rng(4)
    a = rng.integers(-3, 4, (5, 4, 4)).astype(np.float32)
    b = rng.integers(-3, 4, (5, 4, 4)).astype(np.float32)
    got = t_ops.batched_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert_bits(got.numpy(), j_batched_matmul(a, b, interpret=True))


# ------------------------------------------------- bf16 through K1 and K2
def _bf16_special(seed, shape):
    """Random-normal bf16 with NaN, ±inf and ±0 sprinkled in, as numpy
    float32 holding bf16 values (both sides read them exactly)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[:6] = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1e30]
    return torch.from_numpy(x).bfloat16().float().numpy()


def _bf16_bits(got: torch.Tensor, want) -> None:
    want = torch.from_numpy(np.asarray(want, np.float32)).bfloat16()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("km", LAYOUTS + [(4, 4)], ids=str)
def test_allreduce_bf16_plain_path_is_bit_exact_with_pallas(km):
    """The plain version of K1 in bf16 (each add rounded at once) against
    ``pallas_fused``'s reduce-rounds kernel in interpret mode: bit for bit,
    since XLA's CPU adds round each bf16 sum as torch's do."""
    jo = j_dc.allreduce_program(JLayout(JD3(*km)), optimized=True)
    to = t_dc.allreduce_program(TLayout(TD3(*km)), optimized=True)
    x = _bf16_special(13, (jo.n, 37))
    got = CPU.run_allreduce(torch.from_numpy(x).bfloat16(), to)
    _bf16_bits(got, PAL.run_allreduce(jnp.asarray(x, jnp.bfloat16), jo))


@pytest.mark.parametrize("grid", [(1, 2), (2, 2)], ids=str)
def test_combine_rows_bf16_plain_path_is_bit_exact_with_pallas(grid):
    """K2's plain version in bf16 against ``_combine_group_kernel`` run by
    ``pallas_call`` in interpret mode, group by group."""
    from jax.experimental import pallas as pl
    from repro.runtime.backends.pallas_fused import _combine_group_kernel
    from repro_torch.runtime.backends import cuda_fused as cf

    jo = j_dc.matmul_program(*grid, optimized=True)
    groups = [op for op in jo.ops if type(op).__name__ == "FusedCombine"]
    assert groups
    for i, op in enumerate(groups):
        val = _bf16_special(14 + i, (op.gather.shape[1], 9))
        want = pl.pallas_call(
            _combine_group_kernel,
            out_shape=jax.ShapeDtypeStruct(val.shape, jnp.bfloat16),
            interpret=True,
        )(jnp.asarray(op.gather, jnp.int32), jnp.asarray(op.mask, jnp.int32),
          jnp.asarray(val, jnp.bfloat16))
        got = cf.combine_rows(torch.from_numpy(val).bfloat16(), torch.from_numpy(op.gather),
                              torch.from_numpy(op.mask))
        _bf16_bits(got, want)


# ---------------------------------------- K1/K2's packed tables and fused acc
def _planted(seed, shape, rows=None):
    """Random normals with NaN, ±inf and -0.0 planted, in ``rows`` only
    where given (else anywhere)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    where = x if rows is None else x[rows]
    flat = where.reshape(-1)
    picks = rng.choice(flat.size, size=min(flat.size, 6), replace=False)
    flat[picks] = np.array([np.nan, np.inf, -np.inf, -0.0, np.nan, -0.0], np.float32)[: len(picks)]
    if rows is not None:
        x[rows] = where
    return x


@pytest.mark.parametrize("km", LAYOUTS + [(4, 4)], ids=str)
def test_packed_tables_replay_bit_equal_to_pallas(km):
    """The staged body's packed table (the row, or -1 where the mask is
    false) replays as the (gather, mask) pair, as ``np_allreduce`` and as
    ``pallas_fused``'s reduce-rounds kernel in interpret mode, bit for bit,
    on normals and on integers."""
    from repro_torch.runtime.backends import cuda_fused as cf

    jo = j_dc.allreduce_program(JLayout(JD3(*km)), optimized=True)
    to = t_dc.allreduce_program(TLayout(TD3(*km)), optimized=True)
    g, m = t_opt.stacked_combine_tables(to)
    packed = torch.from_numpy(cf.pack_tables(g, m))
    for x in (np.random.default_rng(15).standard_normal((jo.n, 7)).astype(np.float32),
              inputs("allreduce", jo.n, 16)):
        got = cf.replay_packed(torch.from_numpy(x), packed).numpy()
        assert_bits(got, t_opt.replay_allreduce(torch.from_numpy(x), torch.from_numpy(g),
                                                torch.from_numpy(m)).numpy())
        assert_bits(got, t_opt.np_allreduce(x, to))
        assert_bits(got, PAL.run_allreduce(x, jo))


def _pallas_combine_fn(monkeypatch, jo):
    """``pallas_fused``'s own §2 combine hook (``combine_fn`` of
    ``_matmul_executor``, in interpret mode), taken from the call that
    builds its replay."""
    from repro.runtime.backends import pallas_fused

    hooks = {}
    build = j_opt.build_jax_matmul

    def spy(opt, **kw):
        hooks.update(kw)
        return build(opt, **kw)

    monkeypatch.setattr(j_opt, "build_jax_matmul", spy)
    pallas_fused._matmul_executor.__wrapped__(jo, True)
    return hooks["combine_fn"]


@pytest.mark.parametrize("grid", [(1, 2), (2, 2)], ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_rows_acc_bit_exact_with_pallas_combine_fn(monkeypatch, grid, dtype):
    """``combine_rows(val, g, m, acc=acc)``, K2 with its add fused, on the
    CPU against ``pallas_fused``'s combine hook ``acc + _combine_group_kernel(val)``
    for a random non-zero acc, with NaN, ±inf and -0.0 planted in rows that
    the group gathers only where its mask is false: the same bits, in
    float32 and bf16, and nothing planted leaks."""
    from repro_torch.runtime.backends import cuda_fused as cf

    jo = j_dc.matmul_program(*grid, optimized=True)
    combine_fn = _pallas_combine_fn(monkeypatch, jo)
    groups = [op for op in jo.ops if type(op).__name__ == "FusedCombine"]
    assert groups
    X = 3
    for i, op in enumerate(groups):
        n = op.gather.shape[1]
        # the group's tables with every entry that gathers rows 0 and 1 masked
        # off, so those rows are gathered only where the mask is false
        unselected = np.array([0, 1])
        mask = op.mask & ~np.isin(op.gather, unselected)
        val = _planted(17 + i, (n, X, X), unselected)
        acc = np.random.default_rng(30 + i).standard_normal((n, X, X)).astype(np.float32)
        want = combine_fn(jnp.asarray(acc, dtype), jnp.asarray(val, dtype),
                          jnp.asarray(op.gather), jnp.asarray(mask))
        tdt = getattr(torch, dtype)
        got = cf.combine_rows(torch.from_numpy(val).to(tdt).reshape(n, -1),
                              torch.from_numpy(op.gather), torch.from_numpy(mask),
                              acc=torch.from_numpy(acc).to(tdt).reshape(n, -1)).reshape(n, X, X)
        want = torch.from_numpy(np.array(want, np.float32)).to(tdt)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.int16 if dtype == "bfloat16" else torch.int32),
                           want.view(torch.int16 if dtype == "bfloat16" else torch.int32))
        assert bool(torch.isfinite(got.float()).all())  # nothing planted leaked
