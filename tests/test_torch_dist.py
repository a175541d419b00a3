"""The per-shard path over ``torch.distributed``, against the JAX package.

Eight gloo ranks on the CPU (D3(2,2), spawned once for the module through
``repro_torch.launch.mesh.spawn`` with a file store, no ports) run every
case of ``CASES``: all four kinds, native, emulated and combined, in loop,
``overlap`` and ``overlap_fused`` orders, and ``alltoall_compute`` with a
compute closure and with none, through ``TorchDistBackend`` per shard and
whole-array (``run_rank``). The same cases run once through the JAX
package's ``jax_ppermute`` on 8 forced host devices, in a subprocess that
runs this file as a script and is started beside the ranks:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/test_torch_dist.py OUT.npz

Every comparison is bit-exact: integer-valued float32. The native §2
product has no 8-router grid, so it runs grid (1,2) on ranks 0-3.

K5's plain version runs inside the K5 round loop
(``cuda_fused.allreduce_shard_plain``) and is held to the same JAX
per-shard all-reduce; the K5 kernel itself needs a card and is held to
that plain version by the gpu-marked case in ``test_torch_cuda_fused.py``.
The module imports no jax (the JAX side imports it in ``jax_main``), so
the ranks, which import it, start quickly.
"""

import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import emulation
from repro_torch.core.matmul import MatmulGrid, gather_blocks
from repro_torch.core.topology import D3
from repro_torch.dist import collectives
from repro_torch.dist.mesh import DeviceLayout
from repro_torch.launch import mesh
from repro_torch.runtime import optimize as opt
from repro_torch.runtime.backends import cuda_fused as cf
from repro_torch.runtime.backends.cuda_fused import CudaFusedBackend
from repro_torch.runtime.backends.torch_dist import TorchDistBackend
from repro_torch.runtime.rewrite import gather_guest

TESTS = pathlib.Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
PKG = types.SimpleNamespace(D3=D3, DeviceLayout=DeviceLayout, emulation=emulation,
                            collectives=collectives)


# ------------------------------------------- the cases, shared by both sides
HOST = (2, 2)
GUEST = (1, 2)
GRID = (1, 2)  # §2 grid: D3(1, 2), 4 routers
ROOT = 1
FLAVORS = {"loop": {}, "overlap": {"overlap": True}, "fused": {"overlap_fused": True}}


def _cases():
    cases = {}
    for form in ("native", "emu"):
        for flavor in ("loop", "overlap", "fused"):
            cases[f"alltoall-{form}-{flavor}"] = ("alltoall", form, flavor, None)
        for kind in ("allreduce", "broadcast", "matmul"):
            for flavor in ("loop", "overlap"):
                cases[f"{kind}-{form}-{flavor}"] = (kind, form, flavor, None)
        for compute in ("none", "affine"):
            cases[f"alltoall_compute-{form}-{compute}"] = ("alltoall_compute", form, "fused",
                                                           compute)
    for kind in ("alltoall", "allreduce", "broadcast"):
        cases[f"{kind}-comb-loop"] = (kind, "comb", "loop", None)
    return cases


#: name -> (kind, form, flavor, compute)
CASES = _cases()


def program(pkg, name):
    """The case's program, from ``pkg``'s own getters (``pkg`` holds D3,
    DeviceLayout, the emulation module and dist.collectives)."""
    kind, form, flavor, _ = CASES[name]
    host = pkg.D3(*HOST)
    pipelined = 0 if flavor == "loop" else 1
    if form == "comb":
        embs = pkg.emulation.disjoint_embeddings(host, [GUEST, GUEST])
        return pkg.collectives.concurrent_program(kind, embs, roots=(ROOT, ROOT)
                                                  if kind == "broadcast" else None)
    if kind == "matmul":
        emb = pkg.emulation.embed(host, GRID[0] ** 2, GRID[1]) if form == "emu" else None
        return pkg.collectives.matmul_program(*GRID, emb)
    layout = pkg.DeviceLayout(pkg.D3(*(GUEST if form == "emu" else HOST)))
    emb = layout.embed_onto(host) if form == "emu" else None
    if kind in ("alltoall", "alltoall_compute"):
        return pkg.collectives.alltoall_program(layout, emb, pipelined=pipelined)
    if kind == "allreduce":
        return pkg.collectives.allreduce_program(layout, emb)
    return pkg.collectives.broadcast_program(layout, ROOT, emb)


def inputs(name, n):
    """The case's global input arrays (all ranks / devices)."""
    kind, _, _, compute = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    if kind == "matmul":
        side = GRID[0] * GRID[1] * 2
        return tuple(rng.integers(-4, 5, (side, side)).astype(np.float32) for _ in range(2))
    if kind in ("alltoall", "alltoall_compute"):
        x = rng.integers(-4, 5, (n, n, 3)).astype(np.float32)
        return (x, rng.integers(-3, 4, (n, 2)).astype(np.float32)) if compute == "affine" \
            else (x,)
    return (rng.integers(-4, 5, (n, 5)).astype(np.float32),)


def affine(chunks, w):
    """The compute of the ``affine`` cases: one rank's chunks times its
    weight row's first entry plus its second."""
    return chunks * w[0] + w[1]


# -------------------------------------------------- the port's side: a rank
#: cases also run through the ``dist.collectives.dragonfly_*`` entry points
ENTRY_CASES = ("alltoall-native-loop", "alltoall-native-fused", "allreduce-native-loop",
               "broadcast-native-loop", "alltoall_compute-native-affine")


def _shard(be, kind, prog, args, rank, group):
    """This rank's per-shard call of the case."""
    t = [torch.from_numpy(a) for a in args]
    if kind == "alltoall":
        return be.alltoall(t[0][rank], group, prog)
    if kind == "alltoall_compute":
        w = t[1][rank] if len(t) > 1 else None
        fn = None if w is None else (lambda chunks: affine(chunks, w))
        return be.alltoall_compute(t[0][rank], group, prog, fn)
    if kind == "allreduce":
        return be.allreduce(t[0][rank], group, prog)
    if kind == "broadcast":
        waves = prog.num_rounds > 1
        return be.broadcast(t[0][:, rank] if waves else t[0][rank], group, prog)
    b = opt.torch_scatter_guest(opt.torch_scatter_blocks(t[0], prog.grid), prog)
    a = opt.torch_scatter_guest(opt.torch_scatter_blocks(t[1], prog.grid), prog)
    return be.matmul(b[rank], a[rank], group, prog)


def _whole(be, kind, prog, args, group):
    if kind == "alltoall_compute":
        weights = args[1:]
        compute = (lambda chunks, w: affine(chunks, w)) if weights else None
        return be.run_alltoall_compute(args[0], prog, compute, weights, group)
    return getattr(be, f"run_{kind}")(*args, prog, group)


def run_rank(rank, group, layout):
    """Every case on this rank: {name: (shard, whole)} plus the checks of
    the entry points, the plain K5 round loop, the native all-to-all and the
    transport guard."""
    assert layout.n == 8 and (layout.topo.K, layout.topo.M) == HOST
    sub = dist.new_group(list(range(4)))  # the native §2 grid has 4 routers
    out = {}
    for name, (kind, form, flavor, _) in CASES.items():
        prog = program(PKG, name)
        g = sub if prog.n == 4 else group
        if rank >= prog.n:
            continue
        be = TorchDistBackend(**FLAVORS[flavor])
        args = inputs(name, prog.n)
        out[name] = (_shard(be, kind, prog, args, rank, g).numpy(),
                     _whole(be, kind, prog, args, g).numpy())

    host = DeviceLayout(D3(*HOST))
    x = torch.from_numpy(inputs("alltoall-native-loop", 8)[0])
    y = torch.from_numpy(inputs("allreduce-native-loop", 8)[0])
    z = torch.from_numpy(inputs("broadcast-native-loop", 8)[0])
    xc, wc = (torch.from_numpy(a) for a in inputs("alltoall_compute-native-affine", 8))
    entry = {
        "alltoall-native-loop": collectives.dragonfly_all_to_all(x[rank], group, host),
        "alltoall-native-fused": collectives.dragonfly_all_to_all(
            torch.from_numpy(inputs("alltoall-native-fused", 8)[0])[rank], group, host,
            backend=TorchDistBackend(overlap_fused=True)),
        "allreduce-native-loop": collectives.dragonfly_all_reduce(y[rank], group, host),
        "broadcast-native-loop": collectives.dragonfly_broadcast(z[rank], group, host, ROOT),
        "alltoall_compute-native-affine": collectives.dragonfly_all_to_all_compute(
            xc[rank], group, host, lambda chunks: affine(chunks, wc[rank]),
            backend="torch_dist"),
    }
    prog = collectives.allreduce_program(host)
    try:
        TorchDistBackend().allreduce(torch.empty(5, device="meta"), group, prog)
        refused = None
    except ValueError as e:
        refused = str(e)
    return {
        "cases": out,
        "entry": {name: entry[name].numpy() for name in ENTRY_CASES},
        "ring_plain": cf.allreduce_shard_plain(y[rank], group, prog).numpy(),
        "native_all_to_all": collectives.native_all_to_all(x[rank], group).numpy(),
        "transport_refusal": refused,
    }


# ------------------------------------ the JAX side: this file as a script
def jax_main(out: str) -> None:
    """Every case through ``JaxPpermuteBackend`` on 8 forced host devices,
    saved to ``out`` (.npz)."""
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax

    from repro.core import emulation as j_emulation
    from repro.core.topology import D3 as JD3
    from repro.dist import collectives as j_collectives
    from repro.dist.mesh import DeviceLayout as JLayout
    from repro.runtime.backends.jax_ppermute import JaxPpermuteBackend

    assert jax.device_count() >= 8, jax.devices()
    pkg = types.SimpleNamespace(D3=JD3, DeviceLayout=JLayout, emulation=j_emulation,
                                collectives=j_collectives)
    results = {}
    for name, (kind, _, flavor, compute) in CASES.items():
        prog = program(pkg, name)
        be = JaxPpermuteBackend(**FLAVORS[flavor])
        args = inputs(name, prog.n)
        if kind == "alltoall_compute":
            out_ = (be.run_alltoall_compute(args[0], prog, affine, weights=(args[1],))
                    if compute == "affine" else be.run_alltoall_compute(args[0], prog, None))
        else:
            out_ = getattr(be, f"run_{kind}")(*args, prog)
        results[name] = np.asarray(out_)
    np.savez(out, **results)


if __name__ == "__main__":
    jax_main(sys.argv[1])


# ------------------------------------------------------------------- tests
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(per-rank results of the port, {case: JAX result}): the 8 gloo
    ranks and the JAX subprocess run at the same time, once."""
    out = tmp_path_factory.mktemp("jax_ppermute") / "cases.npz"
    path = os.pathsep.join([str(SRC), str(TESTS), os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=path)
    proc = subprocess.Popen([sys.executable, __file__, str(out)],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        ranks = mesh.spawn(run_rank, 8, device="cpu")
    finally:
        log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log
    with np.load(out) as jax_out:
        return ranks, {name: jax_out[name] for name in jax_out.files}


def assert_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(np.ascontiguousarray(got).view(np.uint8),
                                  np.ascontiguousarray(want).view(np.uint8))


def stacked(ranks, name):
    """The per-shard results of a case as the whole-array result."""
    kind = CASES[name][0]
    prog = program(PKG, name)
    shards = [r["cases"][name][0] for r in ranks[:prog.n]]
    if kind == "matmul":
        return gather_blocks(MatmulGrid(*prog.grid), gather_guest(np.stack(shards), prog))
    return np.stack(shards, axis=1 if kind == "broadcast" and prog.num_rounds > 1 else 0)


@pytest.mark.parametrize("name", list(CASES))
def test_per_shard_matches_jax_ppermute(runs, name):
    """Bit-exact: each rank's per-shard call, stacked, against the JAX
    package's per-shard replay on 8 host devices."""
    ranks, jax_out = runs
    assert_bits(stacked(ranks, name), jax_out[name])


@pytest.mark.parametrize("name", list(CASES))
def test_whole_array_matches_jax_ppermute(runs, name):
    """Bit-exact: the whole-array ``run_*`` gives the global result on
    every rank."""
    ranks, jax_out = runs
    prog = program(PKG, name)
    for r in ranks[:prog.n]:
        assert_bits(r["cases"][name][1], jax_out[name])


@pytest.mark.parametrize("name", list(ENTRY_CASES))
def test_collectives_entry_points_match_jax_ppermute(runs, name):
    """Bit-exact: ``dist.collectives.dragonfly_*`` with the default
    ``torch_dist`` backend (or the one passed) on each rank's shard."""
    ranks, jax_out = runs
    assert_bits(np.stack([r["entry"][name] for r in ranks]), jax_out[name])


def test_plain_exchange_in_the_k5_round_loop_matches_jax_ppermute(runs):
    """Bit-exact: ``x = x + ring_exchange_plain(x, partner)`` per round,
    the loop K5 runs on the card, against the JAX per-shard all-reduce."""
    ranks, jax_out = runs
    assert_bits(np.stack([r["ring_plain"] for r in ranks]), jax_out["allreduce-native-loop"])


def test_native_all_to_all_is_the_exchange(runs):
    """``native_all_to_all`` (``all_to_all_single``) moves chunk x[i][j]
    to rank j, as the §3 replay does."""
    ranks, jax_out = runs
    got = np.stack([r["native_all_to_all"] for r in ranks])
    assert_bits(got, jax_out["alltoall-native-loop"])
    assert_bits(got, inputs("alltoall-native-loop", 8)[0].transpose(1, 0, 2))


def test_torch_dist_refuses_tensors_its_transport_cannot_carry(runs):
    ranks, _ = runs
    for r in ranks:
        msg = r["transport_refusal"]
        assert msg is not None and "gloo" in msg and "meta" in msg


def test_allreduce_shard_refuses_emulated_programs():
    """K5 takes native full-involution rounds only; the check comes before
    any use of the group or the card."""
    layout = DeviceLayout(D3(1, 2))
    prog = collectives.allreduce_program(layout, layout.embed_onto(D3(2, 2)))
    with pytest.raises(ValueError, match="full-involution"):
        CudaFusedBackend(device="cpu").allreduce_shard(torch.zeros(4), None, prog)


def test_allreduce_shard_refuses_tensors_off_the_card():
    prog = collectives.allreduce_program(DeviceLayout(D3(2, 2)))
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        CudaFusedBackend(device="cpu").allreduce_shard(torch.zeros(4), None, prog)
    with pytest.raises(ValueError, match="expected 'allreduce'"):
        CudaFusedBackend(device="cpu").allreduce_shard(
            torch.zeros(4), None, collectives.alltoall_program(DeviceLayout(D3(2, 2))))


def test_make_dragonfly_group_on_the_card_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        mesh.make_dragonfly_group(0, 8, init_method="file:///nonexistent")
    with pytest.raises(ValueError, match="'cuda', 'cpu' or 'meta'"):
        mesh.rank_device(0, "xpu")
    assert mesh.rank_device(3, "cpu") == torch.device("cpu")
    assert mesh.rank_device(3, "meta") == torch.device("meta")  # the dry run's fake world


def test_runtime_backend_and_registry():
    from repro_torch.runtime.backends import available_backends, get_backend
    from repro_torch.runtime.backends.torch_dist import TorchDistBackend

    assert "torch_dist" in available_backends()
    assert get_backend("torch_dist", overlap=True) == TorchDistBackend(overlap=True)
    assert mesh.dragonfly_runtime_backend(overlap=True) == TorchDistBackend(overlap=True)
    assert mesh.dragonfly_runtime_backend("reference").name == "reference"
