"""Price-driven collective autotuner: pick the cheapest strategy per call
site, seeded by the paper's analytic prices and calibrated by measurement.

The port of ``repro.runtime.autotune``. The paper prices every algorithm
in rounds (Theorems 1–4, Schedules 1–3) and ``core.costmodel`` encodes
those tables; the runtime has several coexisting execution strategies for
every lowered program. The ``Autotuner`` dispatches on price:

  * a call site is keyed on ``(kind, K·M topology, message bytes, dtype,
    site)`` — ``TuneKey``, whose string is the JAX package's character for
    character; message bytes are bucketed to the next power of two so
    nearby shapes share one decision;
  * the candidate strategies per site class are

      - ``site="host"``   (NumPy whole-array callers):   loop | fused |
        sendrecv
      - ``site="global"`` (whole-array ``run_*`` on a device): loop |
        fused | cuda_fused | sendrecv | native
      - ``site="shard"``  (every rank of a process group with its shard,
        e.g. MoE dispatch): native | loop | overlap | overlap_fused
        (all-to-all only — the wave pipeline that overlaps dispatch with
        the per-destination compute; priced with the max-of-overlap
        discount when the key carries a ``compute_us`` term)
      - ``site="combined"`` (N disjoint guests on one host — the
        multi-tenant fleet's boundary replays): combined | time_mux,
        keyed on the guest-set signature (``decide_combined``);

    where ``loop`` is the per-stage replay on ``torch_dist``, ``overlap``
    the same program in ``start_step`` order, ``fused`` the ``optimize()``
    table replay in plain torch, ``cuda_fused`` the ``CudaFusedBackend``
    (its CUDA kernels), ``sendrecv`` the exported per-device trace replayed
    by the NumPy interpreter, and ``native`` ``torch.distributed``'s own
    collective (``all_to_all_single`` / ``all_reduce`` / ``broadcast``).
    The JAX package names two of them otherwise: ``pallas_fused`` is
    ``cuda_fused`` here and ``xla`` is ``native`` (``RENAMED``);
  * decisions are SEEDED by analytic prices — ``costmodel.price`` of the
    emitted schedule turned into wall-clock by ``costmodel.seconds`` at
    ``BANDWIDTH`` plus per-strategy software-overhead terms — and then
    CALIBRATED by one-shot measured timings, memoized in an on-disk JSON
    cache (``build/autotune_cache.json``; schema-versioned, tagged with
    the device it was measured on, corrupt-tolerant);
  * escape hatches: ``REPRO_TORCH_AUTOTUNE=analytic`` ranks by the seeds
    alone (no measurement, no disk), ``=off`` gives every site its
    pre-autotuner default, ``=<strategy>`` forces one strategy wherever it
    is structurally available; ``REPRO_TORCH_AUTOTUNE_CACHE`` moves the
    cache file. The ``Autotuner`` constructor takes the same knobs.

Agreement across ranks. The JAX tuner runs in one controller; the port
runs one tuner per process, and shard-site closures are collectives. Two
ranks that reached different decisions, or one that hit its cache while
another measured, would issue different collectives and hang. So a
decision made with ``agree_over`` (by default the ``group`` it measures
on) is the group's: its first rank reads the cache and broadcasts the
entry or its absence, every rank runs the same candidates in the same
order (a barrier of the group before each timed call), the vector of
measured times is MAX-all-reduced (the slowest rank's time), and every
rank ranks that common vector. Only the first rank writes the file.

The seed constants are not the JAX package's: those are TPU figures.
Each seed here is either measured on the H100 by ``chip_smoke.py`` or
says that it is not a hardware figure.

Determinism: a warm cache returns the recorded decision (no
re-measurement), analytic ranking is pure arithmetic over the schedule,
and measurement happens at most once per key per cache lifetime.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import costmodel

SCHEMA_VERSION = 1
DEFAULT_CACHE = pathlib.Path(__file__).resolve().parents[3] / "build" / "autotune_cache.json"
ENV_MODE = "REPRO_TORCH_AUTOTUNE"
ENV_CACHE = "REPRO_TORCH_AUTOTUNE_CACHE"

KINDS = ("alltoall", "allreduce", "broadcast", "matmul")
SITES = ("host", "global", "shard", "combined")
STRATEGIES = ("loop", "overlap", "fused", "cuda_fused", "native",
              "overlap_fused", "sendrecv", "combined", "time_mux")
#: strategies that run over a process group of ``program.n`` ranks
GROUP_STRATEGIES = ("loop", "overlap", "native", "overlap_fused")
#: the JAX package's strategy names that the port renames
RENAMED = {"pallas_fused": "cuda_fused", "xla": "native"}
#: shard-site strategy -> the ``moe_collectives`` mode that runs it
EP_MODE = {"native": "xla", "loop": "dragonfly", "overlap": "dragonfly_overlap",
           "overlap_fused": "dragonfly_overlap_fused"}

#: Analytic seed constants: they only rank candidates before the first
#: measurement lands in the cache.
#: Not a hardware figure: the paper's unit hop t_w, one router step.
T_W = 1.0e-6
#: Measured: the card's device-to-device copy rate, bytes copied a second
#: (``chip_smoke.py``'s ``autotune seeds`` line: a 25 MiB ``copy_`` in
#: 0.0231 ms, best of 20; NVIDIA H100 80GB HBM3, power limit 700.00 W).
BANDWIDTH = 1.1346e12
#: Software-overhead estimates, not hardware figures: the host cost of one
#: replayed stage (loop paths), of one fused table group, of one native
#: collective call and of one op of the sendrecv trace interpreter.
T_DISPATCH = 5.0e-6
T_GROUP = 2.0e-6
T_NATIVE = 20.0e-6
T_TRACE_OP = 2.0e-6
#: Measured: the extra cost of a CUDA kernel launch, one K2 (``combine_rows``)
#: launch on (16, 64) float32 rows, 200 back to back, the wrapper's host
#: work included (``chip_smoke.py``'s ``autotune seeds`` line; NVIDIA H100
#: 80GB HBM3, power limit 700.00 W).
T_KERNEL = 2.77e-5
#: Not a hardware figure: a proxy flop rate that sizes the synthetic
#: pipeline compute; it cancels out of ``moe_compute_us`` and
#: ``_measure_closure``'s FFN sizing.
COMPUTE_RATE = 2e9


# ---------------------------------------------------------------------------
# Keys and decisions
# ---------------------------------------------------------------------------

def bucket_bytes(nbytes: int) -> int:
    """Round message bytes up to the next power of two (min 64) so nearby
    shapes share one cache entry and the key space stays bounded."""
    n = max(64, int(nbytes))
    return 1 << (n - 1).bit_length()


def bucket_compute_us(compute_us: int) -> int:
    """Bucket the per-device fused-compute term: 0 (pure collective) stays
    0, anything else rounds up to the next power of two µs."""
    n = int(compute_us)
    return 0 if n <= 0 else 1 << (n - 1).bit_length()


def dtype_name(dtype) -> str:
    """The key's dtype string: numpy's name (``"float32"``), or torch's
    where numpy has none (``"bfloat16"``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    try:
        return str(np.dtype(dtype))
    except TypeError:
        return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class TuneKey:
    """One call site: what is being moved, over which topology, how big.

    ``compute_us`` is the bucketed per-device cost of the compute fused
    into the collective's round trip (MoE expert FFN at dispatch sites);
    0 means a pure data-movement site. ``emulated`` marks guest-on-host
    ``active_devices`` sites, whose candidate set excludes ``native``.
    Pure native sites keep the short key string (no ``|c``/``|emu``
    suffix), as the JAX package's do."""

    kind: str      # alltoall | allreduce | broadcast | matmul
    K: int         # D3(K, M) of the mesh axis (matmul: the grid's topo)
    M: int
    nbytes: int    # bucketed message bytes (per chunk / vector / block)
    dtype: str
    site: str      # host | global | shard | combined
    compute_us: int = 0  # bucketed fused-compute µs per device (0 = none)
    emulated: bool = False  # guest-on-host program (native excluded)
    guests: str = ""  # combined sites: the guest-set signature ("2xD3(1,2)")

    def __str__(self) -> str:
        tail = f"|c{self.compute_us}" if self.compute_us else ""
        tail += "|emu" if self.emulated else ""
        tail += f"|g{self.guests}" if self.guests else ""
        return (f"{self.kind}|K{self.K}M{self.M}|b{self.nbytes}"
                f"|{self.dtype}|{self.site}{tail}")


@dataclasses.dataclass(frozen=True)
class Decision:
    """The tuner's answer for one key, with its full evidence trail."""

    key: TuneKey
    strategy: str
    source: str                     # forced | off | cache | measured | analytic
    rounds: int                     # priced schedule rounds
    hops: float                     # costmodel.price of the schedule, t_w units
    analytic_us: dict[str, float]   # strategy -> analytic seed price
    measured_us: dict[str, float]   # strategy -> measured (empty if analytic)

    @property
    def predicted_us(self) -> float:
        got = self.measured_us.get(self.strategy)
        return got if got is not None else self.analytic_us.get(self.strategy, 0.0)

    def as_row(self) -> dict:
        return {
            "key": str(self.key), "strategy": self.strategy,
            "source": self.source, "rounds": self.rounds, "hops": self.hops,
            "predicted_us": round(self.predicted_us, 1),
            "analytic_us": {k: round(v, 1) for k, v in self.analytic_us.items()},
            "measured_us": {k: round(v, 1) for k, v in self.measured_us.items()},
        }


def _default_strategy(kind: str, site: str) -> str:
    """What each call site did BEFORE the autotuner existed (mode='off')."""
    if site == "combined":
        return "time_mux"  # every tenant served alone
    return "native" if site == "shard" else "loop"


def candidates(kind: str, site: str, *, emulated: bool = False) -> tuple[str, ...]:
    """Structurally available strategies for a (kind, site) class.

    ``emulated`` (guest-on-host ``active_devices`` programs) drops
    ``native``: the group's own collective would mix idle ranks into the
    result."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    if site == "combined":
        return ("combined", "time_mux")
    if site == "host":
        out: tuple[str, ...] = ("loop", "fused", "sendrecv")
    elif site == "global":
        out = ("loop", "fused", "cuda_fused", "sendrecv")
        if kind in ("alltoall", "allreduce"):
            out += ("native",)
    elif site == "shard":
        out = ("loop", "overlap")
        if kind != "matmul":
            out = ("native",) + out
        if kind == "alltoall":
            out += ("overlap_fused",)
    else:
        raise ValueError(f"unknown site {site!r}; expected one of {SITES}")
    if emulated:
        out = tuple(s for s in out if s != "native")
    return out


# ---------------------------------------------------------------------------
# Schedules / programs per kind (lazy dist imports — dist layers on runtime)
# ---------------------------------------------------------------------------

def _schedule(kind: str, layout, grid=None):
    from repro_torch.core import alltoall as a2a
    from repro_torch.core import broadcast as bc
    from repro_torch.core import hypercube as hc
    from repro_torch.core import matmul as mm

    if kind == "alltoall":
        return a2a.schedule(layout.da_params, layout.topo)
    if kind == "allreduce":
        if layout.sbh is None:
            raise ValueError(f"D3({layout.topo.K},{layout.topo.M}) has no SBH")
        return hc.allreduce_schedule(layout.sbh)
    if kind == "broadcast":
        return bc.depth3_schedule(layout.topo, layout.topo.id_router(0))
    if kind == "matmul":
        return mm.schedule(mm.MatmulGrid(*grid))
    raise ValueError(f"unknown kind {kind!r}")


def _program(kind: str, layout, grid=None):
    from repro_torch.dist import collectives as coll

    if kind == "alltoall":
        return coll.alltoall_program(layout)
    if kind == "allreduce":
        return coll.allreduce_program(layout)
    if kind == "broadcast":
        return coll.broadcast_program(layout, 0)
    return coll.matmul_program(*grid)


def layout_for(n: int):
    from repro_torch.dist.mesh import dragonfly_layout

    return dragonfly_layout(n)


def _guest_layout(embedding):
    from repro_torch.dist.mesh import DeviceLayout

    return DeviceLayout(embedding.guest)


# ---------------------------------------------------------------------------
# Analytic seeding
# ---------------------------------------------------------------------------

def analytic_prices(kind: str, layout, nbytes: int, strategies, grid=None,
                    compute_us: int = 0) -> dict[str, float]:
    """Per-strategy analytic seed prices in µs: the schedule's priced hops
    through the bytes-aware ``costmodel.seconds`` plus software-overhead
    terms per replayed stage / fused group / kernel launch.

    ``compute_us`` prices a compute term fused into the site's round trip
    (MoE expert FFN). Sequential strategies pay dispatch + compute + combine
    as a SUM; ``overlap_fused`` issues waves while already-arrived chunks
    are contracted, so it pays max(pipelined wire time, compute) — the
    Schedules 1–3 overlap discount — plus its per-stage table overhead."""
    from repro_torch.runtime import lowering, optimize as ropt

    sched = _schedule(kind, layout, grid)
    hops = costmodel.price(sched, t_w=1.0, t_s=0.0)
    hops_pipe = costmodel.price_pipelined(sched, 1.0, 0.0)
    prog = lowering.lower(sched)
    n_stages = len(prog.stages)
    n_groups = ropt.optimize(prog).num_fused_ops
    n = prog.n
    compute_s = max(0, int(compute_us)) * 1e-6

    def wire(h, overhead):
        return costmodel.seconds(h, T_W, overhead, bytes_per_hop=nbytes, bandwidth=BANDWIDTH)

    out: dict[str, float] = {}
    for s in strategies:
        if s == "loop":
            sec = wire(hops, n_stages * T_DISPATCH)
        elif s == "overlap":
            sec = wire(hops_pipe, n_stages * T_DISPATCH)
        elif s == "fused":
            sec = wire(hops, n_groups * T_GROUP)
        elif s == "cuda_fused":
            sec = wire(hops, n_groups * (T_GROUP + T_KERNEL))
        elif s == "sendrecv":
            # the exported-trace interpreter walks every per-device op —
            # honest seeding keeps it priced above the fused table replay
            from repro_torch.runtime import export as rexport

            sec = wire(hops, rexport.export(prog).num_ops * T_TRACE_OP)
        elif s == "native":
            # one collective call: n-1 exchange steps for all-to-all,
            # 2·log2(n) for an all-reduce ring/tree
            native_hops = (n - 1) if kind == "alltoall" else 2 * max(1, n).bit_length()
            sec = wire(native_hops, T_NATIVE)
        elif s == "overlap_fused":
            w = wire(hops_pipe, 0.0)
            if compute_s and kind == "alltoall":
                # overlap discount: the expert compute hides behind the
                # pipelined dispatch+return rounds (and vice versa) — only
                # the table bookkeeping is serial
                sec = max(2.0 * w, compute_s) + n_stages * T_GROUP
            else:
                sec = w + n_stages * T_GROUP
            out[s] = sec * 1e6
            continue
        else:  # pragma: no cover - candidates() guards the universe
            raise ValueError(f"unknown strategy {s!r}")
        if compute_s and kind == "alltoall":
            # sequential round trip: dispatch + compute + combine
            sec = 2.0 * sec + compute_s
        out[s] = sec * 1e6
    return out


def priced_rounds(kind: str, layout, grid=None) -> tuple[int, float]:
    """(rounds, priced hops in t_w units) of the kind's schedule — the
    paper-table numbers the reports attach to each decision."""
    sched = _schedule(kind, layout, grid)
    return len(sched.rounds), costmodel.price(sched, t_w=1.0, t_s=0.0)


def guest_signature(embeddings) -> str:
    """Canonical guest-set signature for combined-site keys: shape counts
    in sorted order, e.g. ``"2xD3(1,2)"`` or ``"1xD3(1,2)+1xD3(2,2)"`` —
    placement-independent, so re-admitting the same mix after churn hits
    the same cache entry."""
    counts: dict[str, int] = {}
    for e in embeddings:
        s = f"D3({e.guest.K},{e.guest.M})"
        counts[s] = counts.get(s, 0) + 1
    return "+".join(f"{n}x{s}" for s, n in sorted(counts.items()))


def analytic_combined_prices(kind: str, embeddings, nbytes: int) -> dict[str, float]:
    """Seed prices (µs) for one combined site: ``combined`` pays the
    makespan — max of the guests' priced hops — plus the MERGED program's
    per-stage overhead; ``time_mux`` pays the sum of hops plus every solo
    program's stage overhead."""
    from repro_torch.dist import collectives as coll
    from repro_torch.dist.mesh import DeviceLayout
    from repro_torch.runtime import lowering

    hops, stages = [], []
    for emb in embeddings:
        sched = _schedule(kind, DeviceLayout(emb.guest))
        hops.append(costmodel.price(sched, t_w=1.0, t_s=0.0))
        stages.append(len(lowering.lower(sched).stages))
    comb = coll.concurrent_program(kind, tuple(embeddings))
    combined = costmodel.seconds(max(hops), T_W, len(comb.stages) * T_DISPATCH,
                                 bytes_per_hop=nbytes, bandwidth=BANDWIDTH)
    mux = costmodel.seconds(sum(hops), T_W, sum(stages) * T_DISPATCH,
                            bytes_per_hop=nbytes, bandwidth=BANDWIDTH)
    return {"combined": combined * 1e6, "time_mux": mux * 1e6}


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------

def _torch_dtype(dtype: str) -> torch.dtype:
    return getattr(torch, dtype)


def _numpy_dtype(dtype: str):
    """numpy's dtype of that name, or None where numpy has none (bf16)."""
    try:
        return np.dtype(dtype)
    except TypeError:
        return None


def _elems(nbytes: int, dtype: str) -> int:
    itemsize = torch.empty((), dtype=_torch_dtype(dtype)).element_size()
    return max(1, int(nbytes) // itemsize)


def _synced(fn, device: torch.device):
    """``fn`` followed by a wait for the device (the port's
    ``block_until_ready``)."""
    if device.type != "cuda":
        return fn

    def run():
        fn()
        torch.cuda.synchronize(device)
    return run


def _time_us(fn, warmup: int = 1, iters: int = 3, group=None) -> float:
    """Best of ``iters`` host-clock timings of ``fn`` after ``warmup``
    calls; with a ``group``, a barrier of the group before each timed
    call, so every rank times the same collective from the same start."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(iters):
        if group is not None:
            dist.barrier(group=group)
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


def _host_closure(kind: str, strategy: str, prog, grid, e: int, dtype: str):
    """Host-site closure on NumPy inputs (None where numpy has no such
    dtype): the reference replay (loop / fused) or the trace interpreter."""
    from repro_torch.runtime import optimize as ropt
    from repro_torch.runtime.backends.reference import NumpyReferenceBackend
    from repro_torch.runtime.backends.sendrecv import SendRecvBackend

    npd = _numpy_dtype(dtype)
    if npd is None:
        return None
    rng = np.random.default_rng(0)
    if kind == "matmul":
        from repro_torch.core.matmul import MatmulGrid

        side = MatmulGrid(*grid).n * max(1, math.isqrt(e))
        B = rng.integers(-4, 5, (side, side)).astype(npd)
        A = rng.integers(-4, 5, (side, side)).astype(npd)
    elif kind == "alltoall":
        x = rng.standard_normal((prog.n, prog.n, e)).astype(npd)
    else:
        x = rng.standard_normal((prog.n, e)).astype(npd)
    ref = SendRecvBackend() if strategy == "sendrecv" else NumpyReferenceBackend()
    p = ropt.optimize(prog) if strategy == "fused" else prog
    if kind == "matmul":
        return lambda: ref.run_matmul(B, A, p)
    run = getattr(ref, f"run_{kind}")
    return lambda: run(x, p)


def _global_closure(kind: str, strategy: str, prog, grid, e: int, dtype: str,
                    device: torch.device):
    """Global-site closure on inputs built on ``device`` from a seeded
    generator: the backend the ``auto`` backend delegates ``strategy`` to.
    The group strategies have no whole-array form here (None)."""
    from repro_torch.runtime.backends.auto import delegate

    if strategy in GROUP_STRATEGIES:
        return None
    gen = torch.Generator(device=device).manual_seed(0)
    td = _torch_dtype(dtype)
    if kind == "matmul":
        from repro_torch.core.matmul import MatmulGrid

        side = MatmulGrid(*grid).n * max(1, math.isqrt(e))
        args = tuple(torch.randint(-4, 5, (side, side), generator=gen, device=device).to(td)
                     for _ in range(2))
    elif kind == "alltoall":
        args = (torch.randn((prog.n, prog.n, e), generator=gen, device=device).to(td),)
    else:
        args = (torch.randn((prog.n, e), generator=gen, device=device).to(td),)
    be, p = delegate(strategy, prog, device)
    if strategy == "sendrecv":
        if _numpy_dtype(dtype) is None:
            return None
        args = tuple(a.cpu().numpy() for a in args)
    run = getattr(be, f"run_{kind}")
    return _synced(lambda: run(*args, p), device)


def _shard_closure(kind: str, strategy: str, layout, prog, e: int, dtype: str,
                   compute_us: int, device: torch.device, group, carrier: torch.device):
    """Shard-site closure on this rank of ``group``: its shard built on
    ``device``, moved to the carrier for the exchange and back, as
    ``models.moe.moe_apply_ep`` moves its buffers. ``compute_us > 0``
    all-to-all keys time the full round trip — dispatch, a synthetic
    per-chunk contraction sized to ``compute_us`` per device (via
    ``COMPUTE_RATE``), combine — so ``overlap_fused``'s discount shows up
    in the timing instead of being assumed. None where the process has no
    group of ``program.n`` ranks."""
    import torch.nn.functional as F

    from repro_torch.dist.collectives import alltoall_program, native_all_to_all
    from repro_torch.runtime.backends.torch_dist import TorchDistBackend, global_rank

    if group is None or dist.get_world_size(group) != prog.n:
        return None
    n = prog.n
    td = _torch_dtype(dtype)
    gen = torch.Generator(device=device).manual_seed(dist.get_rank(group))

    def to_c(t):
        return t.to(carrier)

    def from_c(t):
        return t.to(device)

    be = TorchDistBackend(overlap=strategy == "overlap",
                          overlap_fused=strategy == "overlap_fused")
    pipe = alltoall_program(layout, pipelined=1) if strategy == "overlap_fused" else prog
    if kind == "matmul":
        X = max(1, math.isqrt(e))
        b, a = (torch.randint(-4, 5, (X, X), generator=gen, device=device).to(td)
                for _ in range(2))
        return _synced(lambda: from_c(be.matmul(to_c(b), to_c(a), group, prog)), device)
    x = torch.randn((n, e) if kind == "alltoall" else (e,), generator=gen,
                    device=device).to(td)

    if kind == "alltoall" and compute_us > 0:
        # the proxy is a silu-gated FFN (6·tokens·d_in·f flops per device)
        # with each chunk factored into (tokens, d_in) rows. d_in is the
        # widest power of two up to a model width (4096) dividing the
        # chunk, where the reference takes at most 64: the flops are the
        # same, but (tokens, f) intermediates 64 times larger than a real
        # MoE's would need 17 GB a rank at Mixtral-8x7B's EP layer key
        f_dim = max(1, int(compute_us * 1e-6 * COMPUTE_RATE / (6.0 * n * e)))
        d_in = next(1 << k for k in range(12, -1, -1) if e % (1 << k) == 0)
        # ~1/sqrt(fan-in) weight scale keeps activations O(1) through the gate
        WG, WI = (torch.randn((d_in, f_dim), generator=gen, device=device).div(
            math.sqrt(d_in)).to(td) for _ in range(2))
        WO = torch.randn((f_dim, d_in), generator=gen, device=device).div(
            math.sqrt(f_dim)).to(td)

        def comp(chunks):
            h = chunks.reshape(-1, d_in)
            return (F.silu(h @ WG) * (h @ WI) @ WO).reshape(chunks.shape)

        if strategy == "overlap_fused":
            def run():
                return from_c(be.alltoall_compute(
                    to_c(x), group, pipe, lambda chunks: to_c(comp(from_c(chunks)))))
        else:
            a2a = ((lambda t: native_all_to_all(t, group)) if strategy == "native"
                   else (lambda t: be.alltoall(t, group, prog)))

            def run():
                return from_c(a2a(to_c(comp(from_c(a2a(to_c(x)))))))
        return _synced(run, device)

    if strategy == "native":
        if kind == "alltoall":
            def run():
                return from_c(native_all_to_all(to_c(x), group))
        else:
            def run():
                t = to_c(x).clone()
                if kind == "allreduce":
                    dist.all_reduce(t, group=group)
                else:
                    dist.broadcast(t, src=global_rank(group, 0), group=group)
                return from_c(t)
        return _synced(run, device)
    per_shard = getattr(be, kind)
    return _synced(lambda: from_c(per_shard(to_c(x), group, pipe)), device)


def _measure_closure(kind: str, site: str, strategy: str, layout, grid, nbytes: int,
                     dtype: str, compute_us: int = 0, *, device=None, group=None,
                     carrier=None):
    """A zero-arg runnable of (kind, strategy) at the keyed message size,
    or None when the strategy cannot run here (a group strategy without a
    group of ``program.n`` ranks, a NumPy replay of a dtype numpy lacks)."""
    prog = _program(kind, layout, grid)
    e = _elems(nbytes, dtype)
    if site == "host":
        return _host_closure(kind, strategy, prog, grid, e, dtype)
    device = torch.device("cpu" if device is None else device)
    if site == "global":
        return _global_closure(kind, strategy, prog, grid, e, dtype, device)
    if strategy not in GROUP_STRATEGIES:
        return None
    return _shard_closure(kind, strategy, layout, prog, e, dtype, compute_us, device,
                          group, carrier)


def _measure_combined_closure(kind: str, strategy: str, embeddings, nbytes: int,
                              dtype: str):
    """A zero-arg runnable of one combined-site strategy, or None when the
    kind has no device-free replay to time. Both arms replay on the NumPy
    reference backend: ``combined`` is ONE merged-program replay,
    ``time_mux`` every guest's solo emulated replay back to back — the
    exact pair of executions the multi-tenant fleet chooses between."""
    npd = _numpy_dtype(dtype)
    if kind not in ("alltoall", "allreduce") or npd is None:
        return None
    from repro_torch.dist import collectives as coll
    from repro_torch.dist.mesh import DeviceLayout
    from repro_torch.runtime.backends.reference import NumpyReferenceBackend
    from repro_torch.runtime.combine import scatter_guests

    ref = NumpyReferenceBackend()
    e = _elems(nbytes, dtype)
    rng = np.random.default_rng(0)
    axes = (0, 1) if kind == "alltoall" else (0,)
    solos, xs = [], []
    for emb in embeddings:
        layout = DeviceLayout(emb.guest)
        n = layout.topo.num_routers
        if kind == "alltoall":
            solos.append(coll.alltoall_program(layout, emb))
            xs.append(rng.standard_normal((n, n, e)).astype(npd))
        else:
            solos.append(coll.allreduce_program(layout, emb))
            xs.append(rng.standard_normal((n, e)).astype(npd))
    run = ref.run_alltoall if kind == "alltoall" else ref.run_allreduce
    if strategy == "combined":
        comb = coll.concurrent_program(kind, tuple(embeddings))
        xh = scatter_guests(xs, embeddings, axes=axes)
        return lambda: run(xh, comb)
    hs = [scatter_guests([x], [emb], axes=axes) for x, emb in zip(xs, embeddings)]

    def mux():
        for prog, xh in zip(solos, hs):
            run(xh, prog)

    return mux


def device_tag(device: torch.device) -> str:
    """The name a cache file records for the device it was measured on."""
    return "cpu" if device.type == "cpu" else torch.cuda.get_device_name(device)


# ---------------------------------------------------------------------------
# The tuner
# ---------------------------------------------------------------------------

class Autotuner:
    """Per-call-site strategy dispatcher with an on-disk measurement cache.

    ``mode``: ``"measure"`` (default — measure once, cache to disk),
    ``"analytic"`` (rank by seed prices only, touch nothing on disk), or
    ``"off"`` (return each site's pre-autotuner default). ``force`` pins
    one strategy wherever it is structurally available. Both default to
    the ``REPRO_TORCH_AUTOTUNE`` variable; ``cache_path`` to
    ``REPRO_TORCH_AUTOTUNE_CACHE`` / ``build/autotune_cache.json``.
    ``device`` is where global- and shard-site closures run: the card
    unless ``"cpu"`` is given (it raises where there is no card). The cache
    file names it; a file measured on another device is ignored.
    """

    def __init__(self, cache_path: str | os.PathLike | None = None,
                 mode: str | None = None, force: str | None = None, device="cuda"):
        env = os.environ.get(ENV_MODE, "").strip()
        if mode is None and force is None and env:
            if env in ("analytic", "off", "measure"):
                mode = env
            elif env in STRATEGIES:
                force = env
            else:
                raise ValueError(
                    f"{ENV_MODE}={env!r}: expected 'analytic', 'off', "
                    f"'measure' or a strategy in {STRATEGIES}")
        if force is not None and force not in STRATEGIES:
            raise ValueError(f"unknown forced strategy {force!r}; known: {STRATEGIES}")
        self.mode = mode or "measure"
        if self.mode not in ("measure", "analytic", "off"):
            raise ValueError(f"unknown mode {self.mode!r}")
        self.force = force
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"the autotuner measures on 'cuda' or 'cpu', not {self.device}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("an autotuner on the card needs a CUDA card and found none; "
                               "pass device='cpu' to measure on the CPU")
        self.cache_path = pathlib.Path(
            cache_path or os.environ.get(ENV_CACHE) or DEFAULT_CACHE)
        self.decisions: list[Decision] = []   # the decision log, for reports
        self._memo: dict[TuneKey, Decision] = {}
        self._cache: dict[str, dict] = self._load_cache()
        self._dirty = False

    # ------------------------------------------------------------- cache
    def _load_cache(self) -> dict[str, dict]:
        """Schema- and device-checked, corrupt-tolerant load: anything
        unreadable, of another schema version or measured on another
        device degrades to an empty cache (analytic seeding still works;
        the next measurement rewrites the file)."""
        try:
            raw = json.loads(self.cache_path.read_text())
            if raw.get("schema") != SCHEMA_VERSION or raw.get("device") != device_tag(self.device):
                return {}
            entries = raw.get("entries")
            return dict(entries) if isinstance(entries, dict) else {}
        except (OSError, ValueError, AttributeError):
            return {}

    def save(self) -> None:
        if not self._dirty:
            return
        payload = {"schema": SCHEMA_VERSION, "device": device_tag(self.device),
                   "entries": self._cache}
        self.cache_path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.cache_path.parent, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.cache_path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        self._dirty = False

    # -------------------------------------------------------- agreement
    @staticmethod
    def _leads(agree_over) -> bool:
        """Whether this process reads and writes the cache for the group."""
        return agree_over is None or dist.get_rank(agree_over) == 0

    def _agreed_entry(self, key: TuneKey, agree_over):
        """The cache entry of ``key`` as the group's first rank reads it
        (or its absence), the same on every rank of ``agree_over``."""
        entry = self._cache.get(str(key)) if self._leads(agree_over) else None
        if agree_over is None:
            return entry
        from repro_torch.runtime.backends.torch_dist import global_rank

        box = [entry]
        dist.broadcast_object_list(box, src=global_rank(agree_over, 0), group=agree_over)
        return box[0]

    def _measured(self, cands, closure, agree_over, carrier) -> dict[str, float]:
        """Each candidate's time in µs, in candidate order; with
        ``agree_over``, every rank times every candidate from a barrier of
        the group and the vector is MAX-all-reduced, so every rank ranks
        the slowest rank's times."""
        times = []
        for s in cands:
            fn = closure(s)
            times.append(math.inf if fn is None else _time_us(fn, group=agree_over))
            del fn
        if agree_over is not None:
            vec = torch.tensor(times, dtype=torch.float64, device=carrier)
            dist.all_reduce(vec, op=dist.ReduceOp.MAX, group=agree_over)
            times = vec.tolist()
        return {s: t for s, t in zip(cands, times) if math.isfinite(t)}

    def _carrier(self, group, carrier):
        if group is None or carrier is not None:
            return carrier
        from repro_torch.launch.mesh import carrier_device

        return carrier_device(str(dist.get_backend(group)), self.device)

    # ------------------------------------------------------------ decide
    def decide(self, kind: str, layout=None, nbytes: int = 0,
               dtype="float32", site: str = "global", grid=None,
               emulated: bool = False, compute_us: int = 0, *, group=None,
               carrier=None, agree_over=None) -> Decision:
        """The cheapest strategy for one call site key. Deterministic for a
        warm cache: same key -> same decision, no re-measurement.

        ``compute_us`` (per-device µs of compute fused into the site's
        round trip, e.g. the MoE expert FFN) keys and prices the decision
        as a full dispatch+compute+combine pipeline. ``group`` is the
        process group shard-site closures run over (none: they cannot run
        here), ``carrier`` the device its exchanges travel on (by default
        the transport's rule, ``launch.mesh.carrier_device``), and
        ``agree_over`` the group whose every rank calls ``decide`` with the
        same key and gets the same decision (default: ``group``)."""
        if kind == "matmul":
            if grid is None:
                raise ValueError("matmul decisions need grid=(K, M)")
            from repro_torch.core.matmul import MatmulGrid

            topo = MatmulGrid(*grid).topo
            if layout is None:
                layout = layout_for(topo.num_routers)
        else:
            if layout is None:
                raise ValueError(f"{kind} decisions need a DeviceLayout")
            topo = layout.topo
        key = TuneKey(kind, topo.K, topo.M, bucket_bytes(nbytes), dtype_name(dtype), site,
                      bucket_compute_us(compute_us), emulated)
        if key in self._memo:
            return self._memo[key]

        cands = candidates(kind, site, emulated=emulated)
        analytic = analytic_prices(kind, layout, key.nbytes, cands, grid, key.compute_us)
        rounds, hops = priced_rounds(kind, layout, grid)

        if self.force is not None:
            strategy = self.force if self.force in cands else cands[0]
            dec = Decision(key, strategy, "forced", rounds, hops, analytic, {})
        elif self.mode == "off":
            dec = Decision(key, _default_strategy(kind, site), "off",
                           rounds, hops, analytic, {})
        elif self.mode == "analytic":
            # analytic mode ignores the cache: its contract is pure
            # deterministic arithmetic over the schedule
            dec = self._conclude(key, rounds, hops, analytic, {}, None)
        else:
            agree_over = group if agree_over is None else agree_over
            carrier = self._carrier(group, carrier)
            dec = self._cached_decision(key, self._agreed_entry(key, agree_over), cands,
                                        rounds, hops, analytic)
            if dec is None:
                def closure(s):
                    return _measure_closure(kind, site, s, layout, grid, key.nbytes,
                                            key.dtype, key.compute_us, device=self.device,
                                            group=group, carrier=carrier)

                measured = self._measured(cands, closure, agree_over,
                                          self._carrier(agree_over, carrier))
                dec = self._conclude(key, rounds, hops, analytic, measured, agree_over)
        self._memo[key] = dec
        self.decisions.append(dec)
        return dec

    @staticmethod
    def _cached_decision(key, ent, cands, rounds, hops, analytic):
        if not isinstance(ent, dict):
            return None
        strategy = ent.get("strategy")
        if strategy not in cands:   # stale/foreign entry: ignore, re-derive
            return None
        measured = ent.get("measured_us")
        measured = dict(measured) if isinstance(measured, dict) else {}
        return Decision(key, strategy, "cache", rounds, hops, analytic, measured)

    def _conclude(self, key, rounds, hops, analytic, measured, agree_over):
        """Rank + record: cheapest measured strategy (persisted to the disk
        cache by the group's first rank) or, with nothing measurable,
        cheapest analytic seed."""
        if measured:
            strategy = min(measured, key=measured.__getitem__)
            dec = Decision(key, strategy, "measured", rounds, hops, analytic, measured)
            self._cache[str(key)] = {
                "strategy": strategy, "source": "measured", "rounds": rounds,
                "measured_us": {k: round(v, 2) for k, v in measured.items()},
                "analytic_us": {k: round(v, 2) for k, v in analytic.items()},
            }
            if self._leads(agree_over):
                self._dirty = True
                self.save()
        else:
            strategy = min(analytic, key=analytic.__getitem__)
            dec = Decision(key, strategy, "analytic", rounds, hops, analytic, {})
        return dec

    # -------------------------------------------------- combined guest sites
    def decide_combined(self, kind: str, embeddings, nbytes: int = 0,
                        dtype="float32", *, group=None, carrier=None) -> Decision:
        """Combined-vs-time-muxed for one tenant SET: should N disjoint
        guests' ``kind`` collectives replay as one merged host program
        (makespan max(T_i)) or one by one (ΣT_i)?

        Keyed on the guest-set signature. Measurement replays both arms on
        the reference backend (device-free); kinds without a reference
        replay rank analytically. ``group``: the ranks that each call this
        with the same tenant set (a fleet over ``torch_dist``); they agree
        on the decision. Memoized and disk-cached like ``decide``."""
        embeddings = tuple(embeddings)
        if not embeddings:
            raise ValueError("decide_combined needs at least one embedding")
        host = embeddings[0].host
        key = TuneKey(kind, host.K, host.M, bucket_bytes(nbytes), dtype_name(dtype),
                      "combined", 0, True, guest_signature(embeddings))
        if key in self._memo:
            return self._memo[key]

        cands = candidates(kind, "combined")
        analytic = analytic_combined_prices(kind, embeddings, key.nbytes)
        from repro_torch.dist import collectives as coll

        rounds = coll.concurrent_program(kind, embeddings).num_rounds
        hops = max(costmodel.price(_schedule(kind, _guest_layout(e)), t_w=1.0, t_s=0.0)
                   for e in embeddings)

        if self.force is not None:
            strategy = self.force if self.force in cands else cands[0]
            dec = Decision(key, strategy, "forced", rounds, hops, analytic, {})
        elif self.mode == "off":
            dec = Decision(key, _default_strategy(kind, "combined"), "off",
                           rounds, hops, analytic, {})
        elif self.mode == "analytic":
            dec = self._conclude(key, rounds, hops, analytic, {}, None)
        else:
            dec = self._cached_decision(key, self._agreed_entry(key, group), cands,
                                        rounds, hops, analytic)
            if dec is None:
                measured = self._measured(
                    cands, lambda s: _measure_combined_closure(kind, s, embeddings, key.nbytes,
                                                               key.dtype),
                    group, self._carrier(group, carrier))
                dec = self._conclude(key, rounds, hops, analytic, measured, group)
        self._memo[key] = dec
        self.decisions.append(dec)
        return dec

    # ------------------------------------------------------------ report
    def report(self) -> list[dict]:
        """The decision table accumulated this process, one row per call."""
        return [d.as_row() for d in self.decisions]


# ---------------------------------------------------------------------------
# Process-wide default tuner (the `backend="auto"` entry points use this)
# ---------------------------------------------------------------------------

_DEFAULT: Autotuner | None = None


def get_autotuner(device=None) -> Autotuner:
    """The process-wide tuner, made on first use on ``device`` (the card by
    default). Asked for another type of device than it measures on, a
    measuring tuner raises (install one with ``set_autotuner``); one that
    measures nothing (analytic, off or forced) answers for any device, the
    dry run's meta device included."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Autotuner(device="cuda" if device is None else device)
    elif (device is not None and torch.device(device).type != _DEFAULT.device.type
          and _DEFAULT.mode == "measure" and _DEFAULT.force is None):
        raise ValueError(f"the process-wide autotuner measures on {_DEFAULT.device}, not "
                         f"{torch.device(device)}: install one with set_autotuner")
    return _DEFAULT


def set_autotuner(tuner: Autotuner | None) -> None:
    """Install (or with None, reset) the process-wide tuner — tests and
    launchers use this to control cache location, mode and device."""
    global _DEFAULT
    _DEFAULT = tuner


# ---------------------------------------------------------------------------
# Config-level reports (serve.engine)
# ---------------------------------------------------------------------------

def moe_compute_us(E_loc: int, c_loc: int, n_model: int, d_model: int, d_ff: int) -> int:
    """Estimated per-device µs of the MoE expert FFN fused into a dispatch
    round trip: each device contracts n_model arriving (E_loc, c_loc,
    d_model) capacity chunks through the silu-gated FFN — three products,
    ~6·tokens·d·f flops — at the proxy ``COMPUTE_RATE``. Shared by
    ``models.moe.moe_apply_ep`` and ``moe_site_report`` so both key the
    same tuner decision."""
    flops = 6.0 * E_loc * c_loc * n_model * d_model * d_ff
    return int(flops / COMPUTE_RATE * 1e6)


def moe_site_report(cfg, rules, n_tokens: int, dtype="float32",
                    tuner: Autotuner | None = None, *, group=None, carrier=None,
                    agree_over=None) -> dict:
    """Chosen strategy + priced rounds for a config's MoE EP dispatch site.

    Mirrors the key ``models.moe.moe_apply_ep`` uses for its dispatch and
    combine all-to-alls: D3 view of the model axis, per-destination buffer
    bytes from the capacity bound at ``n_tokens`` routed tokens. With the
    model axis' ``group`` the decision is measured on it and agreed over
    ``agree_over`` (every rank of which calls this; default: ``group``);
    without one it is analytic. Returns a JSON-ready dict; configs without
    an EP-capable MoE report why."""
    if getattr(cfg, "moe", None) is None:
        return {"status": "n/a", "reason": "config has no MoE"}
    m = cfg.moe
    E = m.num_experts
    n_model = rules.model_axis_size
    if E % n_model:
        return {"status": "n/a",
                "reason": f"E={E} not divisible by model axis {n_model} (TP path)"}
    tuner = tuner or get_autotuner()
    layout = layout_for(n_model)
    shards = max(1, rules.data_axis_size * n_model)
    t_loc = max(1, n_tokens // shards)
    c_loc = max(8, int(m.capacity_factor * t_loc * m.top_k / E))
    c_loc = -(-c_loc // 8) * 8
    itemsize = torch.empty((), dtype=_torch_dtype(dtype_name(dtype))).element_size()
    chunk = (E // n_model) * c_loc * cfg.d_model * itemsize
    dec = tuner.decide(
        "alltoall", layout, chunk, dtype=dtype, site="shard",
        compute_us=moe_compute_us(E // n_model, c_loc, n_model, cfg.d_model, m.d_ff_expert),
        group=group, carrier=carrier, agree_over=agree_over)
    return {
        "status": "ok",
        "kind": "alltoall",
        "topology": f"D3({layout.topo.K},{layout.topo.M})",
        "key": str(dec.key),
        "strategy": dec.strategy,
        "source": dec.source,
        "rounds": dec.rounds,
        "priced_hops": dec.hops,
        "predicted_us": round(dec.predicted_us, 1),
        "analytic_us": {k: round(v, 1) for k, v in dec.analytic_us.items()},
        "measured_us": {k: round(v, 1) for k, v in dec.measured_us.items()},
        "moe_collectives": EP_MODE[dec.strategy],
    }
