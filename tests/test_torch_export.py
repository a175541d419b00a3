"""The port's send/recv export and its ``sendrecv`` backend.

The first part is the JAX package's ``tests/test_export.py`` on
``repro_torch``: ``export -> to_json -> from_json`` is lossless for random
D3(K,M) shapes across all kinds and program forms, the deserialized trace
replays bit-exactly against the ``reference`` backend, and the validator
rejects hand-corrupted traces with the typed error of each violation.

The second part holds the two packages' traces against each other: for
the four collectives in their plain, optimized, emulated and combined
forms, ``repro``'s ``to_json`` and ``repro_torch``'s are the same bytes; a
trace exported by either package validates in the other; and the port's
``sendrecv`` replays it bit-exact (integer-valued float32) against the
port's ``reference`` and ``cuda_fused`` on the CPU.
"""

import dataclasses
import json

import numpy as np
import pytest

try:  # hypothesis is optional — deterministic fallback sampler otherwise
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_fallback import given, settings, strategies as st

from repro.core import emulation as j_emu
from repro.core.topology import D3 as JD3
from repro.dist import collectives as j_dc
from repro.dist.mesh import DeviceLayout as JLayout
from repro.runtime import export as j_export

from repro_torch.core import emulation as t_emu
from repro_torch.core.emulation import embed
from repro_torch.core.matmul import MatmulGrid, gather_blocks, scatter_blocks
from repro_torch.core.topology import D3
from repro_torch.dist import collectives as coll
from repro_torch.dist.mesh import DeviceLayout
from repro_torch.runtime import export as rexport
from repro_torch.runtime import optimize as opt
from repro_torch.runtime.backends import sendrecv as sr
from repro_torch.runtime.backends.cuda_fused import CudaFusedBackend
from repro_torch.runtime.backends.reference import NumpyReferenceBackend

REF = NumpyReferenceBackend()
CPU = CudaFusedBackend(device="cpu")
SR = sr.SendRecvBackend()


def _groups(trace):
    """Bucket a (possibly deserialized) trace's ops by replay group,
    device-major — the interpreter's input form."""
    gs = [[] for _ in range(trace.num_groups)]
    for dev, ops in enumerate(trace.devices):
        for op in ops:
            gs[op.group].append((dev, op))
    return tuple(tuple(g) for g in gs)


def _replay_trace(trace, x):
    """Run the trace interpreter on ``trace`` alone (never the program)."""
    groups = _groups(trace)
    if trace.kind == "alltoall":
        out = np.zeros_like(x)
        sr._replay(trace, groups, {"x": x, "out": out})
        return out
    val = x.copy()  # allreduce / broadcast
    sr._replay(trace, groups, {"val": val})
    return val


def _replay_blocks(trace, b, a):
    """The §2 trace on the block buffers: the c blocks."""
    dtype = np.result_type(b, a)
    val = np.zeros(b.shape, dtype)
    c = np.zeros_like(val)
    sr._replay(trace, _groups(trace),
               {"b": b, "a": a, "val": val, "acc": np.zeros_like(val), "c": c}, dtype=dtype)
    return c


def _replay_from_json(program, x):
    """Run the trace interpreter on the JSON-round-tripped trace only —
    never on the program — so the test proves the serialized form alone
    reproduces the collective."""
    prog = opt.as_program(program)
    trace = rexport.DeviceTrace.from_json(rexport.export(prog).to_json())
    assert trace == rexport.export(prog)  # lossless
    rexport.validate(trace)
    return _replay_trace(trace, x)


def _ints(rng, shape):
    return rng.integers(-4, 5, shape).astype(np.float32)


# ------------------------------------------------------------ round trips
@given(st.sampled_from([(1, 2), (2, 2), (1, 3), (3, 2), (2, 3)]),
       st.sampled_from(["alltoall", "alltoall1", "allreduce", "broadcast"]),
       st.integers(0, 1), st.data())
@settings(max_examples=25, deadline=None)
def test_roundtrip_replay_random_shapes(km, kind, optimized, data):
    """export -> to_json -> from_json -> replay: lossless and bit-exact
    vs the reference backend for random D3(K,M) and every kind."""
    layout = DeviceLayout(D3(*km))
    if kind == "allreduce" and (layout.sbh is None or layout.sbh.dims == 0):
        kind = "alltoall"  # shape has no hypercube — exercise §3 instead
    if kind == "alltoall1":
        prog = coll.alltoall_program(layout, optimized=bool(optimized), pipelined=1)
    elif kind == "alltoall":
        prog = coll.alltoall_program(layout, optimized=bool(optimized))
    elif kind == "allreduce":
        prog = coll.allreduce_program(layout, optimized=bool(optimized))
    else:
        root = data.draw(st.integers(0, layout.topo.num_routers - 1))
        prog = coll.broadcast_program(layout, root, optimized=bool(optimized))
    p = opt.as_program(prog)
    rng = np.random.default_rng(p.n * 7 + optimized)
    if p.kind == "alltoall":
        x = _ints(rng, (p.n, p.n, 2))
        want = REF.run_alltoall(x, prog)
    elif p.kind == "allreduce":
        x = _ints(rng, (p.n, 3))
        want = REF.run_allreduce(x, prog)
    else:
        x = _ints(rng, (p.n, 3))
        want = REF.run_broadcast(x, prog)
    np.testing.assert_array_equal(_replay_from_json(prog, x), want)


def test_roundtrip_replay_matmul():
    """§2 trace JSON round trip, replayed on the block buffers."""
    p = opt.as_program(coll.matmul_program(1, 2))
    g = MatmulGrid(*p.grid)
    rng = np.random.default_rng(3)
    B, A = _ints(rng, (g.n * 2, g.n * 2)), _ints(rng, (g.n * 2, g.n * 2))
    trace = rexport.DeviceTrace.from_json(rexport.export(p).to_json())
    assert trace == rexport.export(p)
    rexport.validate(trace)
    c = _replay_blocks(trace, scatter_blocks(g, B), scatter_blocks(g, A))
    np.testing.assert_array_equal(gather_blocks(g, c), B @ A)


def test_roundtrip_emulated_idle_lists_empty():
    """Emulated programs export with structurally-empty idle op lists, and
    the JSON keeps ``active_devices`` so a consumer can prove it too."""
    emb = embed(D3(2, 2), 1, 2)
    prog = coll.alltoall_program(DeviceLayout(D3(1, 2)), emb)
    trace = rexport.DeviceTrace.from_json(rexport.export(prog).to_json())
    assert trace.active_devices == prog.active_devices
    idle = set(range(trace.n)) - set(trace.active_devices)
    assert idle and all(trace.devices[d] == () for d in idle)
    x = _ints(np.random.default_rng(1), (prog.n, prog.n, 2))
    np.testing.assert_array_equal(_replay_from_json(prog, x), REF.run_alltoall(x, prog))


def test_optimized_form_exports_identically():
    """The fused-table form is the same program — same trace object."""
    layout = DeviceLayout(D3(2, 2))
    plain = coll.alltoall_program(layout)
    fused = coll.alltoall_program(layout, optimized=True)
    assert rexport.export(plain) == rexport.export(fused)


def test_pipelined_waves_are_real_overlap_windows():
    """Schedule-1 pipelining: the same rounds (same per-window send
    counts) launch earlier in the exported trace — each round's window
    opens before the previous round's steps have drained."""
    layout = DeviceLayout(D3(2, 2))
    barrier = rexport.export(coll.alltoall_program(layout))
    piped = rexport.export(coll.alltoall_program(layout, pipelined=1))
    assert barrier.num_sends == piped.num_sends
    assert [c for _, c in barrier.waves()] == [c for _, c in piped.waves()]
    assert piped.waves()[-1][0] < barrier.waves()[-1][0]
    assert all(pw <= bw for (pw, _), (bw, _) in zip(piped.waves(), barrier.waves()))


# ------------------------------------------------------- corrupted traces
def _edit_devices(trace, fn):
    devs = [list(ops) for ops in trace.devices]
    fn(devs)
    return dataclasses.replace(trace, devices=tuple(tuple(ops) for ops in devs))


def _find(trace, op_name):
    for dev, ops in enumerate(trace.devices):
        for i, op in enumerate(ops):
            if op.op == op_name:
                return dev, i, op
    raise AssertionError(f"no {op_name} in trace")


@pytest.fixture(scope="module")
def trace():
    return rexport.export(coll.alltoall_program(DeviceLayout(D3(2, 2))))


def test_validator_accepts_the_export(trace):
    assert rexport.validate(trace) is trace


def test_validator_rejects_stale_schema(trace):
    with pytest.raises(rexport.TraceSchemaError, match="schema 999"):
        rexport.validate(dataclasses.replace(trace, schema=999))


def test_validator_rejects_dropped_recv(trace):
    dev, i, _ = _find(trace, "recv")
    bad = _edit_devices(trace, lambda devs: devs[dev].pop(i))
    with pytest.raises(rexport.TracePairingError, match="matching"):
        rexport.validate(bad)


def test_validator_rejects_double_booked_link(trace):
    dev, i, op = _find(trace, "send")
    bad = _edit_devices(trace, lambda devs: devs[dev].insert(i, op))
    with pytest.raises(rexport.TraceLinkConflictError, match="double-booked"):
        rexport.validate(bad)


def test_validator_rejects_op_on_idle_device(trace):
    emb = embed(D3(2, 2), 1, 2)
    t = rexport.export(coll.alltoall_program(DeviceLayout(D3(1, 2)), emb))
    idle = next(d for d in range(t.n) if d not in t.active_devices)
    _, _, op = _find(t, "copy")
    bad = _edit_devices(t, lambda devs: devs[idle].append(op))
    with pytest.raises(rexport.TraceSchemaError, match="idle device"):
        rexport.validate(bad)


def test_from_json_rejects_garbage():
    with pytest.raises(rexport.TraceSchemaError):
        rexport.DeviceTrace.from_json("not json at all {")
    with pytest.raises(rexport.TraceSchemaError):
        rexport.DeviceTrace.from_json(json.dumps({"kind": "alltoall"}))


# ----------------------------------------------------------- CLI + wiring
def test_cli_validates_files(tmp_path, trace):
    good = tmp_path / "good.json"
    good.write_text(trace.to_json())
    bad = tmp_path / "bad.json"
    bad.write_text(dataclasses.replace(trace, schema=999).to_json())
    assert rexport.main([str(good)]) == 0
    assert rexport.main([str(good), str(bad)]) == 1
    assert rexport.main([]) == 2


def test_dist_device_trace_getter(trace):
    """``dist.collectives.device_trace``: validated, memoized, and the
    fused form maps to the same trace."""
    layout = DeviceLayout(D3(2, 2))
    t1 = coll.device_trace(coll.alltoall_program(layout))
    t2 = coll.device_trace(coll.alltoall_program(layout, optimized=True))
    assert t1 is t2 and t1 == trace


# ------------------------------------------------ the two packages' traces
J = dict(D3=JD3, Layout=JLayout, emu=j_emu, dc=j_dc)
T = dict(D3=D3, Layout=DeviceLayout, emu=t_emu, dc=coll)
HOST = (4, 2)  # emulated and combined forms run on D3(4,2)


def build(pkg, kind, form):
    """One program of ``kind`` in ``form``, built the same way in either
    package: plain and optimized on D3(2,2) (the matmul on grid (1,2)),
    emulated from D3(2,2) (grid (1,2)) onto D3(4,2), combined from two
    guests on D3(4,2)."""
    D3_, Layout, emu, dc = pkg["D3"], pkg["Layout"], pkg["emu"], pkg["dc"]
    if form == "combined":
        shapes = [(1, 2), (1, 2)] if kind == "matmul" else [(2, 2), (1, 2)]
        return dc.concurrent_program(kind, emu.disjoint_embeddings(D3_(*HOST), shapes))
    optimized = form == "optimized"
    if kind == "matmul":
        emb = emu.embed(D3_(*HOST), 1, 2) if form == "emulated" else None
        return dc.matmul_program(1, 2, emb, optimized=optimized)
    layout = Layout(D3_(2, 2))
    emb = layout.embed_onto(D3_(*HOST)) if form == "emulated" else None
    if kind == "alltoall":
        return dc.alltoall_program(layout, emb, optimized=optimized)
    if kind == "allreduce":
        return dc.allreduce_program(layout, emb, optimized=optimized)
    return dc.broadcast_program(layout, 1, emb, optimized=optimized)


CASES = [(kind, form) for kind in ("alltoall", "allreduce", "broadcast", "matmul")
         for form in ("plain", "optimized", "emulated", "combined")]


@pytest.mark.parametrize("kind,form", CASES, ids=lambda v: str(v))
def test_both_packages_export_the_same_bytes(kind, form):
    jp, tp = build(J, kind, form), build(T, kind, form)
    for nbytes in (0, 4096):
        got = rexport.export(tp, nbytes=nbytes).to_json()
        assert got == j_export.export(jp, nbytes=nbytes).to_json()
    assert coll.device_trace(tp).to_json() == j_dc.device_trace(jp).to_json()


def _agreeing_run(prog, rng):
    """Inputs for ``prog`` and the output on which the port's reference,
    cuda_fused on the CPU and sendrecv agree bit for bit. The §2 program
    runs at the blocks level, (n, 2, 2) blocks with zeros on idle devices
    (a combined program has no whole-matrix form); its whole-matrix form
    is checked across the three backends besides, where it has one."""
    p = opt.as_program(prog)
    if p.kind == "matmul":
        b, a = (_ints(rng, (p.n, 2, 2)) * p.active_mask_np[:, None, None] for _ in range(2))
        want = REF.matmul_blocks(b, a, prog)
        np.testing.assert_array_equal(SR.matmul_blocks(b, a, prog), want)
        if p.active_devices is None or p.guest_n == MatmulGrid(*p.grid).n:
            N = MatmulGrid(*p.grid).n * 2
            B, A = _ints(rng, (N, N)), _ints(rng, (N, N))
            np.testing.assert_array_equal(SR.run_matmul(B, A, prog), B @ A)
            np.testing.assert_array_equal(CPU.run_matmul(B, A, prog).numpy(), B @ A)
            np.testing.assert_array_equal(REF.run_matmul(B, A, prog), B @ A)
        return (b, a), want
    x = _ints(rng, (p.n, p.n, 2) if p.kind == "alltoall" else (p.n, 3))
    run = f"run_{p.kind}"
    want = getattr(REF, run)(x, prog)
    np.testing.assert_array_equal(getattr(CPU, run)(x, prog).numpy(), want)
    np.testing.assert_array_equal(getattr(SR, run)(x, prog), want)
    return (x,), want


@pytest.mark.parametrize("kind,form", CASES, ids=lambda v: str(v))
def test_traces_cross_between_the_packages(kind, form):
    """A trace either package exports validates in the other, and the
    JAX package's trace, read by the port, replays bit-exact in the port's
    sendrecv interpreter, on the output the port's backends agree on."""
    jp, tp = build(J, kind, form), build(T, kind, form)
    jtext, ttext = j_export.export(jp).to_json(), rexport.export(tp).to_json()
    j_export.validate(j_export.DeviceTrace.from_json(ttext))
    trace = rexport.validate(rexport.DeviceTrace.from_json(jtext))
    assert trace == rexport.export(tp)
    args, want = _agreeing_run(tp, np.random.default_rng(len(ttext)))
    got = _replay_blocks(trace, *args) if kind == "matmul" else _replay_trace(trace, *args)
    np.testing.assert_array_equal(got, want)
