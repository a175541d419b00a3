"""Emulated and combined programs in the port, against the JAX package.

Property 2's rewrite (``runtime.rewrite.emulate``) and the concurrent-guest
merge (``runtime.combine``) are NumPy in both packages. Over a grid of
(host, guest) layouts the port's programs must equal the JAX package's
stage for stage: stamps, pairs, σ tables, masks, ``active_devices`` and
the fused tables of their optimized form; the same inputs must raise the
same ``GuestConflictError``. The emulated and combined program forms of
the conformance sweep then run through the port's ``reference`` and
``cuda_fused(device="cpu")`` and must be bit-exact (integer-valued
float32) with the JAX package's ``reference`` and its ``pallas_fused`` in
interpret mode.
"""

import dataclasses
import types

import numpy as np
import pytest

from repro.core import emulation as j_emu
from repro.core.simulator import verify as j_verify
from repro.core.topology import D3 as JD3
from repro.dist import collectives as j_dc
from repro.dist.mesh import DeviceLayout as JLayout
from repro.core import alltoall as j_a2a
from repro.runtime import combine as j_comb
from repro.runtime import optimize as j_opt
from repro.runtime import program as j_prog
from repro.runtime import rewrite as j_rw
from repro.runtime.backends.pallas_fused import PallasFusedBackend
from repro.runtime.backends.reference import NumpyReferenceBackend as JRef

from repro_torch.core import alltoall as t_a2a
from repro_torch.core import emulation as t_emu
from repro_torch.core.matmul import MatmulGrid
from repro_torch.core.simulator import verify as t_verify
from repro_torch.core.topology import D3 as TD3
from repro_torch.dist import collectives as t_dc
from repro_torch.dist.mesh import DeviceLayout as TLayout
from repro_torch.runtime import combine as t_comb
from repro_torch.runtime import optimize as t_opt
from repro_torch.runtime import program as t_prog
from repro_torch.runtime import rewrite as t_rw
from repro_torch.runtime.backends.cuda_fused import CudaFusedBackend
from repro_torch.runtime.backends.reference import NumpyReferenceBackend as TRef

J = types.SimpleNamespace(D3=JD3, Layout=JLayout, emu=j_emu, dc=j_dc, rw=j_rw, comb=j_comb,
                          opt=j_opt, prog=j_prog, a2a=j_a2a, verify=j_verify)
T = types.SimpleNamespace(D3=TD3, Layout=TLayout, emu=t_emu, dc=t_dc, rw=t_rw, comb=t_comb,
                          opt=t_opt, prog=t_prog, a2a=t_a2a, verify=t_verify)

#: label -> (host, emulated guest, combined guest shapes, emulated matmul grid)
COMBOS = {
    "D3(4,2)>D3(2,2)": ((4, 2), (2, 2), ((2, 2), (1, 2)), (1, 2)),
    "D3(4,4)>D3(2,2)": ((4, 4), (2, 2), ((2, 2), (2, 2)), (1, 2)),
    "D3(4,4)>D3(4,2)": ((4, 4), (4, 2), ((4, 2), (4, 2)), (2, 2)),
}
FORMS = ("alltoall-emu", "alltoall-pipe1-emu", "allreduce-emu", "broadcast-emu",
         "matmul-emu", "alltoall-comb", "alltoall-pipe1-comb", "allreduce-comb",
         "broadcast-comb")
KINDS = ("alltoall", "allreduce", "broadcast", "matmul")
JREF, TREF = JRef(), TRef()
PAL = PallasFusedBackend(interpret=True)
CPU = CudaFusedBackend(device="cpu")


def build(pkg, combo, form, optimized=False):
    """The program of one form, built the same way in either package."""
    host, guest, shapes, grid = COMBOS[combo]
    kind, *rest = form.split("-")
    pipelined = 1 if "pipe1" in rest else 0
    if rest[-1] == "comb":
        embs = pkg.emu.disjoint_embeddings(pkg.D3(*host), shapes)
        return pkg.dc.concurrent_program(kind, embs, optimized=optimized, pipelined=pipelined)
    if kind == "matmul":
        emb = pkg.emu.embed(pkg.D3(*host), grid[0] ** 2, grid[1])
        return pkg.dc.matmul_program(*grid, emb, optimized=optimized)
    layout = pkg.Layout(pkg.D3(*guest))
    emb = layout.embed_onto(pkg.D3(*host))
    if kind == "alltoall":
        return pkg.dc.alltoall_program(layout, emb, optimized=optimized, pipelined=pipelined)
    if kind == "allreduce":
        return pkg.dc.allreduce_program(layout, emb, optimized=optimized)
    return pkg.dc.broadcast_program(layout, layout.n - 1, emb, optimized=optimized)


def plain(x):
    """Package-neutral value: arrays as lists, dataclasses as their class
    name and fields."""
    if isinstance(x, np.ndarray):
        return x.tolist()
    if dataclasses.is_dataclass(x):
        return type(x).__name__, dataclasses.astuple(x)
    return x


def meta(d):
    return sorted(((k, plain(v)) for k, v in d.items()), key=str)


def stage_signature(st):
    kind = type(st).__name__
    row = [kind, st.round_index, st.step, st.start_step]
    if kind == "LocalContract":
        return row + [st.fn, st.mask, st.n, plain(st.mask_np) if st.n else None]
    row.append(tuple(st.pairs))
    if kind == "Perm":
        row += [st.n, plain(st.sigma_np), plain(st.inverse_np), plain(st.src_np),
                plain(st.dst_np)]
    elif kind == "Match":
        row += [plain(st.dst_mask_np), plain(st.src_np), plain(st.dst_np)]
    else:
        row += [st.combine, plain(st.self_mask_np), plain(st.dst_mask_np),
                st.is_full_permutation]
    return row


def program_signature(prog):
    active = None if prog.active_devices is None else (
        prog.active_devices, plain(prog.active_np), plain(prog.active_mask_np), prog.guest_n)
    return (prog.kind, prog.n, prog.num_rounds, prog.root, prog.grid, prog.name, active,
            [stage_signature(st) for st in prog.stages])


def fused_signature(opt):
    return [(type(op).__name__,
             [(f.name, plain(getattr(op, f.name))) for f in dataclasses.fields(op)])
            for op in opt.ops] + [opt.uniform_rounds]


def assert_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(np.ascontiguousarray(got).view(np.uint8),
                                  np.ascontiguousarray(want).view(np.uint8))


# ------------------------------------------------------------ the rewrite
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("combo", COMBOS)
def test_emulate_equals_the_jax_rewrite(combo, kind):
    """``emulate`` gives the JAX package's program: stamps, pairs, σ
    tables, masks and ``active_devices``; its fused tables too."""
    form = f"{kind}-emu"
    jp, tp = build(J, combo, form), build(T, combo, form)
    assert tp.active_devices is not None
    assert program_signature(tp) == program_signature(jp)
    assert fused_signature(build(T, combo, form, True)) == \
        fused_signature(build(J, combo, form, True))


@pytest.mark.parametrize("combo", COMBOS)
def test_emulate_schedule_and_checks_equal_the_jax_package(combo):
    """The verification view maps every hop as the JAX package's does,
    verifies conflict-free on the host, and both packages refuse the same
    bad embeddings."""
    host, guest, _, _ = COMBOS[combo]
    views = []
    for pkg in (J, T):
        layout = pkg.Layout(pkg.D3(*guest))
        emb = layout.embed_onto(pkg.D3(*host))
        sched = pkg.a2a.pipelined_schedule(layout.da_params, 1, layout.topo)
        view = pkg.rw.emulate_schedule(sched, emb)
        report = pkg.verify(view.topo, view)
        assert not report.conflicts
        views.append((view.name, [([(h.step, h.src, h.dst, h.payload) for h in r.hops],
                                   meta(r.meta)) for r in view.rounds], meta(view.meta)))
        prog = pkg.dc.alltoall_program(layout)
        whole_host = pkg.emu.embed(pkg.D3(*host), *host)
        with pytest.raises(ValueError, match="stacking rewrites"):
            pkg.rw.emulate(pkg.rw.emulate(prog, emb), whole_host)
        other = pkg.emu.embed(pkg.D3(*host), 1, 1)
        with pytest.raises(ValueError, match="embedding's guest"):
            pkg.rw.emulate(prog, other)
    assert views[0] == views[1]


def test_emulate_is_cached_per_program_and_embedding():
    layout = TLayout(TD3(2, 2))
    emb = layout.embed_onto(TD3(4, 2))
    prog = t_dc.allreduce_program(layout)
    assert t_rw.emulate(prog, emb) is t_rw.emulate(prog, emb)
    assert t_dc.allreduce_program(layout, emb) is t_dc.allreduce_program(layout, emb)


# ------------------------------------------------------------ the merge
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("combo", COMBOS)
def test_combine_equals_the_jax_merge(combo, kind):
    """``combine`` (through ``concurrent_program``) packs the guests as the
    JAX package does; the Schedule-IR merge of their host views too."""
    host, guest, shapes, grid = COMBOS[combo]
    if kind == "matmul":  # matmul guests share one shape: two grid guests
        shapes = ((grid[0] ** 2, grid[1]),) * 2
    sigs, scheds = [], []
    for pkg in (J, T):
        embs = pkg.emu.disjoint_embeddings(pkg.D3(*host), shapes)
        prog = pkg.dc.concurrent_program(kind, embs)
        opt = pkg.dc.concurrent_program(kind, embs, optimized=True)
        sigs.append((program_signature(prog), fused_signature(opt),
                     sorted(pkg.dc.concurrent_programs(embs))))
        views = [pkg.rw.emulate_schedule(pkg.a2a.schedule(
            pkg.Layout(e.guest).da_params, e.guest), e) for e in embs]
        merged = pkg.comb.combine_schedules(views)
        scheds.append((merged.name, meta(merged.meta), [
            ([(h.step, h.src, h.dst, h.payload) for h in r.hops], meta(r.meta))
            for r in merged.rounds]))
    assert sigs[0] == sigs[1]
    assert scheds[0] == scheds[1]


def _conflicts(pkg):
    """Inputs on which ``combine`` must refuse, built the same way in both."""
    host = pkg.D3(4, 4)
    layout = pkg.Layout(pkg.D3(2, 2))
    embs = pkg.emu.disjoint_embeddings(host, [(2, 2), (2, 2)])
    prog = pkg.dc.alltoall_program(layout)
    solos = [pkg.rw.emulate(prog, e) for e in embs]
    clash = pkg.rw.emulate(prog, pkg.emu.embed(host, 2, 2, c_set=(1, 2), p_set=(0, 1)))
    P, RC, CP = pkg.prog.Perm, pkg.prog.ReduceCombine, pkg.prog.CollectiveProgram
    link_a = CP("alltoall", 4, 1, (P(((0, 2), (2, 0)), n=4),), active_devices=(0, 1))
    link_b = CP("alltoall", 4, 1, (P(((0, 2), (2, 0)), n=4),), active_devices=(2, 3))
    write_a = CP("allreduce", 4, 1, (RC(4, ((0, 2),)),), active_devices=(0, 2))
    write_b = CP("allreduce", 4, 1, (RC(4, ((1, 2),), start_step=1),), active_devices=(1, 3))
    self_a = CP("allreduce", 4, 1, (RC(4, ((1, 3),)),), active_devices=(1, 2))
    self_b = CP("allreduce", 4, 1, (RC(4, ((3, 3),)),), active_devices=(0, 3))
    g = pkg.emu.disjoint_embeddings(host, [(1, 2), (1, 2)])
    small = pkg.dc.matmul_program(1, 2, g[0])
    big = pkg.dc.matmul_program(2, 2, pkg.emu.embed(host, 4, 2, p_set=(2, 3)))
    return {"overlapping images": [solos[0], clash], "shared link": [link_a, link_b],
            "doubly written device": [write_a, write_b], "self pair write": [self_a, self_b],
            "matmul skeletons": [small, big]}


@pytest.mark.parametrize("case", list(_conflicts(T)))
def test_guest_conflicts_raise_as_in_the_jax_package(case):
    errors = []
    for pkg in (J, T):
        with pytest.raises(pkg.comb.GuestConflictError) as ei:
            pkg.comb.combine(_conflicts(pkg)[case])
        e = ei.value
        errors.append((str(e), e.guests, e.device, e.step, e.link))
    assert errors[0] == errors[1]


# ----------------------------------------------------------- the replays
def _inputs(prog, seed):
    rng = np.random.default_rng(seed)
    if prog.kind == "alltoall":
        return (rng.integers(-4, 5, (prog.n, prog.n, 3)).astype(np.float32),)
    if prog.kind in ("allreduce", "broadcast"):
        return (rng.integers(-4, 5, (prog.n, 5)).astype(np.float32),)
    side = MatmulGrid(*prog.grid).n * 2
    return tuple(rng.integers(-4, 5, (side, side)).astype(np.float32) for _ in range(2))


def _run(backend, program, args):
    kind = (program.program if hasattr(program, "ops") else program).kind
    out = getattr(backend, f"run_{kind}")(*args, program)
    return out.numpy() if hasattr(out, "numpy") else np.asarray(out)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("combo", COMBOS)
def test_forms_replay_bit_exact_with_the_jax_backends(combo, form):
    """Bit-exact on integer-valued float32: the port's ``reference`` and
    ``cuda_fused(device="cpu")``, plain and optimized, against the JAX
    package's ``reference`` (plain) and ``pallas_fused`` (interpret mode)."""
    jp = build(J, combo, form)
    args = _inputs(jp, hash(combo + form) % 2**32)
    want = _run(JREF, jp, args)
    assert_bits(_run(PAL, build(J, combo, form, True), args), want)
    for optimized in (False, True):
        tp = build(T, combo, form, optimized)
        assert_bits(_run(TREF, tp, args), want)
        assert_bits(_run(CPU, tp, args), want)


@pytest.mark.parametrize("combo", COMBOS)
def test_matmul_guests_through_one_combined_replay(combo):
    """``run_matmul_guests``: two guests' whole-matrix products through one
    combined replay on each package's reference, equal bit for bit and to
    B @ A."""
    host, _, _, grid = COMBOS[combo]
    side = MatmulGrid(*grid).n * 3
    rng = np.random.default_rng(7)
    Bs = [rng.integers(-4, 5, (side, side)).astype(np.float32) for _ in range(2)]
    As = [rng.integers(-4, 5, (side, side)).astype(np.float32) for _ in range(2)]
    outs = []
    for pkg, ref in ((J, JREF), (T, TREF)):
        embs = pkg.emu.disjoint_embeddings(pkg.D3(*host), [(grid[0] ** 2, grid[1])] * 2)
        for optimized in (False, True):
            prog = pkg.dc.concurrent_program("matmul", embs, optimized=optimized)
            outs.append(pkg.comb.run_matmul_guests(ref, Bs, As, pkg.opt.as_program(prog)
                                                   if optimized else prog, embs))
    for got in outs:
        for g, B, A in zip(got, Bs, As):
            assert_bits(g, B @ A)


def test_guest_data_movement_matches_the_jax_helpers():
    host = (4, 4)
    xs = [np.arange(8 * 3, dtype=np.float32).reshape(8, 3) + 100 * g for g in range(2)]
    outs = []
    for pkg in (J, T):
        embs = pkg.emu.disjoint_embeddings(pkg.D3(*host), [(2, 2), (2, 2)])
        packed = pkg.comb.scatter_guests(xs, embs, fill=-1)
        progs = [pkg.dc.allreduce_program(pkg.Layout(e.guest), e) for e in embs]
        outs.append((packed, pkg.comb.gather_guests(packed, embs),
                     [pkg.comb.extract_guest(packed, p) for p in progs]))
    assert_bits(outs[1][0], outs[0][0])
    for a, b in zip(outs[1][1] + outs[1][2], outs[0][1] + outs[0][2]):
        assert_bits(a, b)
