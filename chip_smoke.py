#!/usr/bin/env python3
"""Drive the port's collective runtime, dense and MoE model paths and
per-shard path on one NVIDIA card, end to end.

    python3 chip_smoke.py

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``src/repro_torch/csrc`` and prints the
   build time and the compiler's register and spill report;
3. holds each kernel against its plain torch version on the card, at the
   shapes the main path gives it: reduce_rounds and combine_rows (with
   and without its fused acc) bit-exact, each of their two bodies (staged,
   slab) in float32 and in bf16 with NaN, ±inf and -0.0 planted, timed per
   body beside combine_rows' library yardstick, ``torch.sparse.mm`` of the
   group's CSR selection matrix (timed only, never called by the port);
   block_matmul exact on integer-valued inputs and within
   rtol = atol = 2e-4 on random-normal ones (its tf32x3 body splits each
   operand into TF32 hi and lo parts and sums in another order); prints
   how far block_matmul and cuBLAS's float32 product each are from the
   float64 product;
4. drives the four collectives at full width through the user's entry
   points (``dist.collectives.*_program``, then
   ``runtime.backends.get_backend("cuda_fused").run_*``) and holds each,
   bit for bit, against the port's plain torch path on the card, counting
   every kernel launch and body: run_allreduce one staged reduce_rounds,
   run_matmul 32 staged combine_rows, each with its acc, and 16 tf32x3
   block products;
5. holds all four, at a reduced width, against the port's NumPy
   ``reference`` backend, bit for bit;
6. times every kernel and collective with CUDA events (median of several
   runs after a warm-up) beside its bound, the least time the card could
   take: the larger of bytes moved over 3.35 TB/s and operations over the
   card's peak rate for the work the function needs, the H100 SXM
   data-sheet peaks at 700 W: 67 TFLOP/s float32 outside the tensor cores,
   495 TFLOP/s TF32 for block_matmul's 2·X³ a block (beside it
   ``ffma_bound_ms``, the same work at the FFMA rate, and
   ``tf32x3_route_bound_ms``, the three TF32 products its design takes),
   989 TFLOP/s bf16 for flash attention; combine_rows' hook (with acc)
   beside its own bound, three passes of the buffer
   (``combine_hook_ms``, ``combine_hook_bound_ms``);
7. holds flash attention (K4) against its plain version on the card: at
   TinyLlama-1.1B's prefill shape (q (8, 2048, 32, 64) bf16, k/v
   (8, 2048, 4, 64), causal), at small shapes with head_dim 64, 96
   (Phi-3-mini's) and 128, with a sliding window of 32 at Sq != Sk and at
   ragged lengths, and at Mixtral-8x7B's prefill shape (q (1, 8192, 32,
   128) bf16, k/v (1, 8192, 8, 128), causal, window 4096). bf16 within |Δ| <= 1e-2 + 1e-2·|want| everywhere and
   ||Δ|| <= 1e-2·||want|| (bf16 out, and p rounds to bf16 after scaling
   by running maxima taken over other key tiles: about one bf16 step of
   2^-8); float32 within 2e-4 in both. Shows that the bf16 bound rejects
   planted faults: on batch row 0 of the prefill shape, a materialised
   attention with the causal mask off by one, or without the diagonal
   key, or without the diagonal 64-key tile, fails it, and the same
   attention with the right mask passes. Times the kernel beside the
   plain version and ``F.scaled_dot_product_attention`` (timed only,
   never called by the port) and its bound at the 989 TFLOP/s of the bf16
   tensor cores, and the host time of one call of the wrapper at the
   prefill shape, bf16 (the wgmma body, three TMA tensor maps encoded per
   call) beside float32 (the mma_sync body, no maps); at the Mixtral
   shape, its time beside the plain version, SDPA given the same window
   as a boolean mask (KV heads expanded beforehand; timed only) and its
   bound, the keys inside the causal window at the bf16 tensor-core rate;
8. runs TinyLlama-1.1B's prefill forward at full width (22 layers,
   random weights from a seed, tokens (8, 2048), its published context)
   through ``models.model.forward_train`` and ``loss_fn``: exactly 22 K4
   launches per forward, finite logits and loss, and last-token logits
   and loss held against the same forward on the naive attention oracle
   (bf16 through 22 layers: max |Δ| <= 0.5 and ||Δ|| <= 5 % of ||logits||,
   loss within 0.1 %); prints its ms, tokens/s and peak GiB;
9. serves 6 requests (prompts of 3–8 tokens, 12 new tokens each, the JAX
   launcher's smoke defaults) through ``serve.engine.Engine`` at full
   width with 4 slots and a 2048-token cache, checks that each gets its
   12 tokens and that the decode path's logits at the first request's
   last prompt token match the prefill forward's on that prompt (the
   logits tolerance of step 8); prints its steps, tokens/s and peak GiB. This
   is a functional check: such toy traffic does not measure serving
   throughput;
10. profiles one prefill forward and one engine step with torch.profiler:
   device time by kernel group (flash attention, matrix products, the
   rest), kernels per call, and the idle share of the wall time;
11. runs Mixtral-8x7B at its published widths (d 4096, 32 heads, 8 KV
   heads of 128, 8 experts top-2 of d_ff 14336, vocab 32000, window 4096,
   bf16) with the depth cut from 32 layers to 8 (all 32 layers of bf16
   weights take 93 GB, more than the card's 80 GB), random weights from
   seed 0 made on the card: ``forward_train`` and ``loss_fn`` on tokens
   (1, 8192) from seed 0 (one sequence: the capacity couples every token
   of a batch), exactly 8 K4 launches all on the wgmma body, against the
   naive forward with step 8's criteria; the share of (token, layer)
   routes that differ between the two passes under 3 %, and each token's
   first differing route at a near-tie of the kernel pass (its router
   probabilities at the nearest rank boundary within 0.02): the bf16
   noise between the passes grows with depth and flips near-ties, not
   clear choices; prints its ms,
   tokens/s, device ms by group (expert products, dispatch and combine,
   K4, the rest) from torch.profiler, kernels per call, idle share, the
   peak GiB of each pass and the share of (token, k) entries the capacity
   dropped; then the engine on the same model with 4 slots, 6 requests,
   a 128-token cache and 12 new tokens each (the JAX launcher's smoke
   defaults; its rate is a smoke figure, not serving throughput), held
   like step 9's;
12. runs the per-shard §4 all-reduce: 8 processes share the card in one
   gloo group (``launch.mesh.spawn``, D3(2,2)), each with a 25 MiB bucket
   from the seed plus its rank, and call
   ``CudaFusedBackend().allreduce_shard`` 5 times back to back with fresh
   data (in call 2 rank 3 sleeps 50 ms before its first put), 3 rounds of
   K5 each: 3 puts, 3 signals and 3 waits per call per rank, counted.
   Every call is held bit for bit against the plain exchange on host
   copies, and the first against the NumPy ``np_allreduce`` and K1
   ``run_allreduce`` on the stacked (8, 6553600) array. Prints each rank's
   median ms of one call, of one put, of one wait (add included), of one
   plain call and of one local 25 MiB ``copy_`` (the yardstick), the
   bound of one call of all 8 ranks (per round and rank: read x, read the
   partner's x, write the sum; the staging copy through the window is the
   design's cost, not the function's) and the bound of one put.

The float32 products of the plain versions, the references and the
library calls run in full float32: TF32 is switched off for cuBLAS and
cuDNN (block_matmul's tf32x3 body takes TF32 on purpose, three products
of split operands). Every failure raises and exits non-zero before the last
line, which is ``{"ok": true, "device": {...}}``. Without a card the
script exits non-zero at once: it has no CPU path.

The cells (layout D3(K, M) has n = K·M² routers):

  all-to-all  D3(4,4), n = 64, x (64, 64, 262144) f32: 1 MiB per (src, dst)
              chunk, 64 tokens × 4096 d_model of an MoE dispatch;
  all-reduce  D3(4,4), x (64, 6553600) f32: 25 MiB per router, PyTorch
              DDP's default gradient bucket;
  broadcast   D3(4,4) from root 0, the same 25 MiB per router;
  matmul      grid (4,4) = D3(16,4), n = 256, X = 512: B, A 8192 × 8192 f32
              with integer entries in [-4, 4], so B @ A is exact;
  per-shard   D3(2,2), 8 ranks (one 8-GPU node's shape) sharing the card,
  all-reduce  x (6553600,) f32 per rank: the DDP bucket again.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core rate; only for bf16 tensor-core work
TF32_FLOP_PER_S = 495e12  # dense TF32 tensor-core rate; block_matmul's tf32x3 body
SEED = 0
CHUNK = 262144  # all-to-all: floats per (src, dst) chunk, 1 MiB
BUCKET = 6553600  # all-reduce and broadcast: floats per router, 25 MiB
BLOCK = 512  # matmul: X, the side of each router's block
PREFILL = (8, 2048)  # TinyLlama-1.1B prefill: batch, tokens (its published context)
MIXTRAL_LAYERS = 8  # of 32: 8 layers of bf16 weights are 23.7 GB, all 32 are 93 GB
MIXTRAL_TOKENS = (1, 8192)  # one sequence of twice the window
ROUTE_FLIP_MAX = 0.03  # share of (token, layer) routes the kernel and naive passes may differ on
FIRST_FLIP_GAP_MAX = 0.02  # a token's first differing route must be a near-tie: the kernel
# pass's router probabilities at ranks k, k + 1 (or k - 1, k) closer than this
FLASH_TOL = {"torch.bfloat16": 1e-2, "torch.float32": 2e-4}  # K4: rtol = atol = relative rms
LOGIT_MAX_ABS, LOGIT_REL_RMS, LOSS_REL = 0.5, 0.05, 1e-3  # bf16 model-path tolerances
RANKS = 8  # per-shard phase: D3(2,2), the shape of one 8-GPU node, all on one card here
CALLS = 5  # back-to-back allreduce_shard calls with fresh data
SKEW = (2, 3, 0.05)  # in call 2, rank 3 sleeps 50 ms before its first put


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def zero_counts(wrappers) -> None:
    """Set every launch count of these kernel wrappers to 0, each body's too."""
    for fn in wrappers:
        fn.launches = 0
        if hasattr(fn, "body_launches"):
            fn.body_launches = dict.fromkeys(fn.body_launches, 0)
        if hasattr(fn, "acc_launches"):
            fn.acc_launches = 0


def per_shard_rank(rank, group, layout, seed):
    """One rank of the per-shard phase: CALLS back-to-back calls of
    ``CudaFusedBackend().allreduce_shard`` on a fresh 25 MiB buffer each
    (one rank late by SKEW), with K5's launch counts set to 0 just before
    and read just after; then each call held bit for bit against the plain
    version on host copies, and this rank's times. Returns host data."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import collectives as dc
    from repro_torch.launch.mesh import rank_device
    from repro_torch.runtime.backends import cuda_fused as cf

    dev = rank_device(rank)
    prog = dc.allreduce_program(layout)
    be = cf.CudaFusedBackend()
    gen = torch.Generator(device=dev).manual_seed(seed + rank)
    xs = [torch.randn(BUCKET, generator=gen, device=dev) for _ in range(CALLS)]
    k5 = (cf.ring_put, cf.ring_signal, cf.ring_wait_add)
    torch.cuda.synchronize()
    dist.barrier()
    for kernel in k5:
        kernel.launches = 0
    outs = []
    for call, x in enumerate(xs):
        if (call, rank) == SKEW[:2]:
            time.sleep(SKEW[2])
        outs.append(be.allreduce_shard(x, group, prog))
    counts = {kernel.__name__: kernel.launches for kernel in k5}

    err = 0.0
    for call, (x, got) in enumerate(zip(xs, outs)):
        want, got = cf.allreduce_shard_plain(x.cpu(), group, prog), got.cpu()
        require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                f"rank {rank}, call {call}: K5 differs from the plain exchange")
        err = max(err, float((got - want).abs().max()))

    def host_ms(fn, reps):
        times = []
        for _ in range(reps):
            dist.barrier()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def event_ms(fn, reps):
        times = []
        for _ in range(reps):
            dist.barrier()
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        return statistics.median(times)

    x, xh = xs[0], xs[0].cpu()
    window, partners = cf.ring_window(group, x, prog), cf.ring_partners(prog)
    call_ms = host_ms(lambda: be.allreduce_shard(x, group, prog), 10)
    plain_ms = host_ms(lambda: cf.allreduce_shard_plain(xh, group, prog), 3)
    dst = torch.empty_like(x)
    copy_ms = event_ms(lambda: dst.copy_(x), 10)
    put_ms, wait_ms = [], []
    for _ in range(10):  # allreduce_shard's rounds, with events around put and wait
        dist.barrier()
        window.epoch += 1
        val, events = x, []
        for r, table in enumerate(partners):
            e = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            e[0].record()
            cf.ring_put(val, window, r, int(table[rank]))
            e[1].record()
            cf.ring_signal(window, r, int(table[rank]))
            if window.shared:  # as ring_exchange
                torch.cuda.current_stream().synchronize()
                dist.barrier()
            e[2].record()
            val = cf.ring_wait_add(val, window, r, int(table[rank]))
            e[3].record()
            events.append(e)
        window.check()
        put_ms += [e[0].elapsed_time(e[1]) for e in events]
        wait_ms += [e[2].elapsed_time(e[3]) for e in events]
    orchestration = "barrier" if window.shared else "spin"
    cf.close_ring_windows(group)
    return {"counts": counts, "rounds": len(partners), "max_abs_err": err,
            "orchestration": orchestration,
            "out0": outs[0].cpu().numpy(), "call_ms": call_ms, "plain_ms": plain_ms,
            "copy_ms": copy_ms, "put_ms": statistics.median(put_ms),
            "wait_ms": statistics.median(wait_ms)}


def per_shard_phase(dev, seed):
    """The per-shard §4 all-reduce: RANKS processes share the card in one
    gloo group (D3(2,2)), each with a 25 MiB bucket, CALLS calls of
    allreduce_shard (K5) back to back. Holds every call against the plain
    exchange (in the ranks) and the first against the port's NumPy
    np_allreduce and K1 run_allreduce on the stacked (RANKS, BUCKET) array
    (the data holds no -0.0, checked, so the per-shard x + x_partner and
    the whole-array fold from +0.0 agree bit for bit). Returns K5's record for
    the kernels line."""
    import numpy as np
    import torch

    from repro_torch.dist import collectives as dc
    from repro_torch.dist.mesh import dragonfly_layout
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import spawn
    from repro_torch.runtime import optimize as opt
    from repro_torch.runtime.backends import get_backend

    layout = dragonfly_layout(RANKS)
    require((layout.topo.K, layout.topo.M) == (2, 2), f"dragonfly_layout({RANKS}) is {layout.topo}")
    build.build_all()  # the ranks only load the libraries
    t0 = time.perf_counter()
    ranks = spawn(per_shard_rank, RANKS, device="cuda", args=(seed,))
    phase_s = time.perf_counter() - t0
    rounds = ranks[0]["rounds"]
    per_call = {"ring_put": rounds, "ring_signal": rounds, "ring_wait_add": rounds}
    for r, res in enumerate(ranks):
        require(res["counts"] == {k: CALLS * v for k, v in per_call.items()},
                f"rank {r} launched {res['counts']} in {CALLS} calls of {rounds} rounds")

    gens = [torch.Generator(device=dev).manual_seed(seed + r) for r in range(RANKS)]
    x = torch.stack([torch.randn(BUCKET, generator=g, device=dev) for g in gens])
    require(not bool(((x == 0) & torch.signbit(x)).any()), "the per-shard input holds -0.0")
    prog = dc.allreduce_program(layout, optimized=True)
    k1 = get_backend("cuda_fused").run_allreduce(x, prog).cpu().numpy()
    ref = opt.np_allreduce(x.cpu().numpy(), prog)
    for r, res in enumerate(ranks):
        for what, want in (("np_allreduce", ref[r]), ("K1 run_allreduce", k1[r])):
            require(np.array_equal(res["out0"].view(np.int32), want.view(np.int32)),
                    f"rank {r}: allreduce_shard differs from {what}")
    del x, k1, ref

    # A round of a rank reads x and the partner's x and writes the sum, once
    # each; the put's write into the window and the wait's read of it are
    # the design's staging copy, not the function's work. All ranks share
    # the card. A put alone moves its buffer twice.
    nbytes = RANKS * rounds * 3 * BUCKET * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, RANKS * rounds * BUCKET / FP32_FLOP_PER_S
    put_bound_ms = 2 * BUCKET * 4 / HBM_BYTES_PER_S * 1e3
    keys = ("call_ms", "put_ms", "wait_ms", "plain_ms", "copy_ms")
    med = {key: statistics.median(res[key] for res in ranks) for key in keys}
    emit({"run": "allreduce_shard", "ranks": RANKS, "layout": "D3(2,2)", "bucket_floats": BUCKET,
          "calls": CALLS, "skew": {"call": SKEW[0], "rank": SKEW[1], "s": SKEW[2]},
          "rounds": rounds, "launches_per_rank": ranks[0]["counts"], "phase_s": phase_s,
          "orchestration": ranks[0]["orchestration"],
          "bit_exact": ["plain exchange", "np_allreduce", "K1 run_allreduce"],
          "per_rank_ms": {key: [res[key] for res in ranks] for key in keys},
          "median_ms": med, "bound_ms": max(t_bytes, t_ops) * 1e3, "put_bound_ms": put_bound_ms})
    return dict(
        name="ring_exchange", route="cuda", source="src/repro_torch/csrc/ring_exchange.cu",
        replaces="src/repro/runtime/backends/pallas_fused.py:111",
        launches=sum(ranks[0]["counts"].values()),
        max_abs_err=max(res["max_abs_err"] for res in ranks), ms=med["call_ms"],
        plain_ms=med["plain_ms"], bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=med["copy_ms"])


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA card; this script runs the "
                 "port on the card and has no CPU path")
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.matmul import MatmulGrid
    from repro_torch.dist import collectives as dc
    from repro_torch.dist.mesh import dragonfly_layout
    from repro_torch.kernels import build
    from repro_torch.kernels.block_matmul.block_matmul import block_matmul
    from repro_torch.kernels.block_matmul.ref import block_matmul_ref
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, flash_attention_plain)
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.runtime import optimize as opt
    from repro_torch.runtime.backends import get_backend
    from repro_torch.runtime.backends import cuda_fused as cf
    from repro_torch.serve.engine import Engine, Request

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kind = torch.cuda.get_device_name(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def randint(*shape):
        return torch.randint(-4, 5, shape, generator=gen, device=dev).float()

    def same_bits(a, b) -> bool:
        return (a.shape == b.shape and a.dtype == b.dtype
                and torch.equal(a.contiguous().view(torch.uint8),
                                b.contiguous().view(torch.uint8)))

    def max_abs_err(a, b) -> float:
        return float((a.float() - b.float()).abs().max())

    def time_ms(fn, reps=5, warmup=2, calls=1) -> float:
        """Median ms of one call over ``reps`` timings of ``calls`` calls
        back to back (more than one keeps the card busy past the host's
        cost of a call, so a short kernel's time is the card's)."""
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / calls)
        return statistics.median(times)

    def bound(nbytes: float, flops: float, rate: float = FP32_FLOP_PER_S) -> tuple[float, str]:
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
        return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")

    def release():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # ------------------------------------------------------------ 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(build.SOURCES)}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    be = get_backend("cuda_fused")
    ref = get_backend("reference")
    t0 = time.perf_counter()
    layout = dragonfly_layout(64)
    require((layout.topo.K, layout.topo.M) == (4, 4), f"dragonfly_layout(64) is {layout.topo}")
    progs = {
        "alltoall": dc.alltoall_program(layout, optimized=True),
        "allreduce": dc.allreduce_program(layout, optimized=True),
        "broadcast": dc.broadcast_program(layout, 0, optimized=True),
        "matmul": dc.matmul_program(4, 4, optimized=True),
    }
    print(f"programs: derived and fused in {time.perf_counter() - t0:.2f} s", flush=True)
    n, n_mm = layout.n, progs["matmul"].n
    F, X, N = BUCKET, BLOCK, MatmulGrid(4, 4).n * BLOCK

    # ------------------------------------- 3. each kernel against its plain version
    kernels = {}

    def planted(*shape, dtype=torch.float32):
        """Random normals with NaN, ±inf and -0.0 at a few random places."""
        x = randn(*shape)
        flat = x.view(-1)
        picks = torch.randint(0, flat.numel(), (6,), generator=gen, device=dev)
        flat[picks] = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0, -0.0,
                                    float("nan")], device=dev)
        return x.to(dtype)

    # K1 and K2: each body against the plain version, float32 and bf16, with
    # special values planted; times of each body. bf16 adds round at once.
    t = opt.to_device_tables(opt.allreduce_tables(progs["allreduce"]), dev)
    t["packed"] = cf.pack_tables(t["gather"], t["mask"])
    R, k = t["gather"].shape[:2]
    allreduce_ops = R * (k + 1) * n * F  # k selected adds and the self-add per round
    k1 = {"ms": {}, "bound_ms": {}}
    for dtype in (torch.float32, torch.bfloat16):
        x = planted(n, F, dtype=dtype)
        want = cf._reduce_rounds_plain(x, t["gather"], t["mask"])
        esize = x.element_size()
        k1["bound_ms"][str(dtype)] = bound(2 * n * F * esize + R * k * n * 5, allreduce_ops)
        for body in cf.BODIES:
            got = cf.reduce_rounds(x, t["gather"], t["mask"], packed=t["packed"], body=body)
            require(same_bits(got, want), f"reduce_rounds ({body}, {dtype}) differs from its "
                                          "plain version")
            k1["ms"][f"{body} {dtype}"] = time_ms(
                lambda: cf.reduce_rounds(x, t["gather"], t["mask"], packed=t["packed"],
                                         body=body), reps=10)
        k1["ms"][f"plain {dtype}"] = time_ms(
            lambda: cf._reduce_rounds_plain(x, t["gather"], t["mask"]), reps=3, warmup=1)
        if dtype == torch.float32:
            err = max_abs_err(got.nan_to_num(), want.nan_to_num())
        del x, got, want
        release()
    b_ms, b_by = k1["bound_ms"]["torch.float32"]
    kernels["reduce_rounds"] = dict(
        name="reduce_rounds", route="cuda", source="src/repro_torch/csrc/reduce_rounds.cu",
        replaces="src/repro/runtime/backends/pallas_fused.py:133",
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        ms=k1["ms"]["staged torch.float32"], plain_ms=k1["ms"]["plain torch.float32"],
        library_ms=None, body_ms=k1["ms"])
    emit({"check": "reduce_rounds", "shape": [n, F], "tables": [R, k, n], "bit_exact": True,
          "special_values": True, **k1})

    groups = [tabs for kind_, _, tabs in opt.matmul_tables(progs["matmul"]) if kind_ == "combine"]
    require(len(groups) == 32, f"expected 32 combine groups at grid (4,4), got {len(groups)}")
    k2 = {"k": [], "ms": {}, "hook_ms": {}, "bound_ms": {}, "hook_bound_ms": {}}
    for dtype in (torch.float32, torch.bfloat16):
        val, acc = planted(n_mm, X * X, dtype=dtype), randn(n_mm, X * X).to(dtype)
        widths = set()
        for tabs in groups[:2]:  # one round's two groups (k = 5 and k = 4)
            tc = opt.to_device_tables(tabs, dev)
            tc["packed"] = cf.pack_tables(tc["gather"], tc["mask"])
            want = cf._combine_rows_plain(val, tc["gather"], tc["mask"])
            for body in cf.BODIES:
                for with_acc in (False, True):
                    got = cf.combine_rows(val, tc["gather"], tc["mask"], packed=tc["packed"],
                                          acc=acc if with_acc else None, body=body)
                    require(same_bits(got, acc + want if with_acc else want),
                            f"combine_rows ({body}, {dtype}, acc={with_acc}) differs from its "
                            "plain version")
            widths.add(tc["gather"].shape[0])
        k2["k"] = sorted(widths)
        kk = tc["gather"].shape[0]
        esize = val.element_size()
        k2["bound_ms"][str(dtype)] = bound(2 * n_mm * X * X * esize + kk * n_mm * 5,
                                           kk * n_mm * X * X)
        k2["hook_bound_ms"][str(dtype)] = bound(3 * n_mm * X * X * esize + kk * n_mm * 5,
                                                (kk + 1) * n_mm * X * X)
        for body in cf.BODIES:
            k2["ms"][f"{body} {dtype}"] = time_ms(lambda: cf.combine_rows(
                val, tc["gather"], tc["mask"], packed=tc["packed"], body=body), calls=10)
            k2["hook_ms"][f"{body} {dtype}"] = time_ms(lambda: cf.combine_rows(
                val, tc["gather"], tc["mask"], packed=tc["packed"], acc=acc, body=body), calls=10)
        k2["ms"][f"plain {dtype}"] = time_ms(
            lambda: cf._combine_rows_plain(val, tc["gather"], tc["mask"]), calls=10)
        k2["hook_ms"][f"plain {dtype}"] = time_ms(
            lambda: acc + cf._combine_rows_plain(val, tc["gather"], tc["mask"]), calls=10)
        if dtype == torch.float32:
            err = max_abs_err(got.nan_to_num(), (acc + want).nan_to_num())
            # the library's way to the same sums: the group's (n, n) selection
            # matrix times val through cuSPARSE (another order of the adds)
            rows = torch.arange(n_mm, device=dev).expand(kk, n_mm)
            sel = torch.sparse_coo_tensor(
                torch.stack([rows[tc["mask"]], tc["gather"][tc["mask"]].long()]),
                torch.ones(int(tc["mask"].sum()), device=dev), (n_mm, n_mm)).coalesce()
            csr = sel.to_sparse_csr()
            library_ms = time_ms(lambda: torch.sparse.mm(csr, val), calls=10)
            del csr, sel
        del val, acc, got, want
        release()
    b_ms, b_by = k2["bound_ms"]["torch.float32"]
    kernels["combine_rows"] = dict(
        name="combine_rows", route="cuda", source="src/repro_torch/csrc/reduce_rounds.cu",
        replaces="src/repro/runtime/backends/pallas_fused.py:161",
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        ms=k2["ms"]["staged torch.float32"], plain_ms=k2["ms"]["plain torch.float32"],
        library_ms=library_ms, body_ms=k2["ms"],
        combine_hook_ms=k2["hook_ms"]["staged torch.float32"],
        combine_hook_bound_ms=k2["hook_bound_ms"]["torch.float32"][0])
    emit({"check": "combine_rows", "shape": [n_mm, X * X], "bit_exact": True,
          "special_values": True,
          "library": "torch.sparse.mm (CSR selection matrix)", "library_ms": library_ms, **k2})
    release()

    a, b = randint(n_mm, X, X), randint(n_mm, X, X)
    zero_counts((block_matmul,))
    require(same_bits(block_matmul(a, b), block_matmul_ref(a, b)),
            "block_matmul is not exact on integer-valued inputs")
    a, b = randn(n_mm, X, X), randn(n_mm, X, X)
    got, want = block_matmul(a, b), block_matmul_ref(a, b)
    require(torch.allclose(got, want, rtol=2e-4, atol=2e-4),
            f"block_matmul off by {max_abs_err(got, want)} on random-normal inputs")
    require(block_matmul.body_launches == {"simt": 0, "tf32x3": 2},
            f"block_matmul's checks launched {block_matmul.body_launches}")
    exact = torch.bmm(a.double(), b.double())  # how far each float32 product is from exact
    err_f64 = {"tf32x3": max_abs_err(got, exact), "cublas_f32": max_abs_err(want, exact)}
    del exact
    # the function's 2·X³ a block at the TF32 tensor cores' rate; beside it
    # the same work at the FFMA rate and the tf32x3 design's three products
    mm_bytes = 3 * n_mm * X * X * 4
    b_ms, b_by = bound(mm_bytes, 2 * n_mm * X ** 3, TF32_FLOP_PER_S)
    kernels["block_matmul"] = dict(
        name="block_matmul", route="cuda", source="src/repro_torch/csrc/block_matmul.cu",
        replaces="src/repro/kernels/block_matmul/block_matmul.py:46",
        max_abs_err=max_abs_err(got, want), bound_ms=b_ms, bound_by=b_by,
        ffma_bound_ms=bound(mm_bytes, 2 * n_mm * X ** 3)[0],
        tf32x3_route_bound_ms=bound(mm_bytes, 3 * 2 * n_mm * X ** 3, TF32_FLOP_PER_S)[0],
        ms=time_ms(lambda: block_matmul(a, b)),
        plain_ms=time_ms(lambda: block_matmul_ref(a, b)),
        library_ms=time_ms(lambda: torch.bmm(a, b)))
    emit({"check": "block_matmul", "shape": [n_mm, X, X], "body": "tf32x3",
          "exact_on_integers": True, "rtol": 2e-4, "atol": 2e-4, "max_abs_err_vs_f64": err_f64,
          **{key: kernels["block_matmul"][key] for key in (
              "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
              "ffma_bound_ms", "tf32x3_route_bound_ms")}})
    del a, b, got, want
    release()

    # --------------------------------------- 4. the main path at full width
    counters = (cf.reduce_rounds, cf.combine_rows, block_matmul)
    expected = {
        "alltoall": {},
        "allreduce": {"reduce_rounds": 1},
        "broadcast": {},
        "matmul": {"combine_rows": 32, "block_matmul": 16},
    }
    plain = {
        "alltoall": lambda x: opt.torch_alltoall(progs["alltoall"], dev)(x),
        "allreduce": lambda x: opt.torch_allreduce(progs["allreduce"], dev)(x),
        "broadcast": lambda x: opt.torch_broadcast(progs["broadcast"], dev)(x),
        "matmul": lambda B, A: opt.torch_gather_blocks(
            opt.torch_matmul_blocks(progs["matmul"], dev)(
                opt.torch_scatter_blocks(B, (4, 4)), opt.torch_scatter_blocks(A, (4, 4))),
            (4, 4)),
    }
    run = {
        "alltoall": lambda x: be.run_alltoall(x, progs["alltoall"]),
        "allreduce": lambda x: be.run_allreduce(x, progs["allreduce"]),
        "broadcast": lambda x: be.run_broadcast(x, progs["broadcast"]),
        "matmul": lambda B, A: be.run_matmul(B, A, progs["matmul"]),
    }
    inputs = {
        "alltoall": lambda: (randn(n, n, CHUNK),),
        "allreduce": lambda: (randn(n, F),),
        "broadcast": lambda: (randn(n, F),),
        "matmul": lambda: (randint(N, N), randint(N, N)),
    }
    launches = {fn.__name__: 0 for fn in counters}
    runs = []
    for coll in ("alltoall", "allreduce", "broadcast", "matmul"):
        args = inputs[coll]()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(counters)
        got = run[coll](*args)
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in counters}
        bodies = dict(block_matmul.body_launches)
        require(counts == {name: expected[coll].get(name, 0) for name in counts},
                f"run_{coll} launched {counts}, expected {expected[coll]}")
        if coll == "allreduce":  # the main-path shape takes the staged body
            k1_bodies = dict(cf.reduce_rounds.body_launches)
            require(k1_bodies == {"slab": 0, "staged": 1},
                    f"run_allreduce launched reduce_rounds' bodies {k1_bodies}")
            kernels["reduce_rounds"].update(body="staged", body_launches=k1_bodies)
        if coll == "matmul":  # tf32x3 products, staged combines each with its acc
            require(bodies == {"simt": 0, "tf32x3": counts["block_matmul"]},
                    f"run_matmul launched block_matmul's bodies {bodies}")
            kernels["block_matmul"].update(body="tf32x3", body_launches=bodies)
            k2_bodies = dict(cf.combine_rows.body_launches)
            require(k2_bodies == {"slab": 0, "staged": 32} and cf.combine_rows.acc_launches == 32,
                    f"run_matmul launched combine_rows' bodies {k2_bodies}, "
                    f"{cf.combine_rows.acc_launches} with acc")
            kernels["combine_rows"].update(body="staged", body_launches=k2_bodies,
                                           acc_launches=cf.combine_rows.acc_launches)
        for name, count in counts.items():
            launches[name] += count
        want = plain[coll](*args)
        require(same_bits(got, want), f"run_{coll} differs from the plain torch path")
        if coll == "alltoall":  # the native exchange is the (src, dst) transpose
            require(same_bits(got, args[0].transpose(0, 1).contiguous()), "all-to-all is not x[j, i]")
        elif coll == "allreduce":
            total = args[0].sum(0, keepdim=True).expand_as(got)
            require(torch.allclose(got, total, rtol=1e-5, atol=1e-4), "all-reduce is not the sum")
        elif coll == "broadcast":
            require(same_bits(got, args[0][:1].expand_as(got)), "broadcast is not root 0's row")
        else:
            require(same_bits(got, torch.matmul(*args)), "run_matmul is not B @ A")
        require(bool(torch.isfinite(got).all()), f"run_{coll} has non-finite values")
        peak = torch.cuda.max_memory_allocated() / 2**30
        del got, want
        release()
        io_bytes = sum(t.numel() * 4 for t in args) + args[0].numel() * 4
        flops = {"allreduce": allreduce_ops, "matmul": 2 * N ** 3}
        b_ms, b_by = bound(io_bytes, flops.get(coll, 0))
        rec = {"run": coll, "shape": [list(t.shape) for t in args], "bit_exact_vs_plain": True,
               "launches": counts, "peak_gib": peak,
               **({"block_matmul_bodies": bodies, "combine_rows_bodies": k2_bodies,
                   "combine_rows_acc_launches": cf.combine_rows.acc_launches}
                  if coll == "matmul" else
                  {"reduce_rounds_bodies": k1_bodies} if coll == "allreduce" else {}),
               "ms": time_ms(lambda: run[coll](*args), reps=3, warmup=1),
               "plain_ms": time_ms(lambda: plain[coll](*args), reps=3, warmup=1),
               "bound_ms": b_ms, "bound_by": b_by}
        runs.append(rec)
        emit(rec)
        del args
        release()
    for name in ("reduce_rounds", "combine_rows", "block_matmul"):
        require(launches[name] > 0, f"the main path never launched {name}")

    # ------------------------------- 5. reduced width against the NumPy reference
    rng = np.random.default_rng(SEED)
    plain_progs = {
        "alltoall": dc.alltoall_program(layout),
        "allreduce": dc.allreduce_program(layout),
        "broadcast": dc.broadcast_program(layout, 0),
        "matmul": dc.matmul_program(4, 4),
    }
    N_small = MatmulGrid(4, 4).n * 4
    small = {
        "alltoall": (rng.standard_normal((n, n, 8)).astype(np.float32),),
        "allreduce": (rng.standard_normal((n, 1000)).astype(np.float32),),
        "broadcast": (rng.standard_normal((n, 1000)).astype(np.float32),),
        "matmul": tuple(rng.integers(-4, 5, (N_small, N_small)).astype(np.float32)
                        for _ in range(2)),
    }
    for coll, args in small.items():
        for form, prog in (("optimized", progs[coll]), ("plain", plain_progs[coll])):
            got = getattr(be, f"run_{coll}")(*args, prog).cpu().numpy()
            want = getattr(ref, f"run_{coll}")(*args, prog)
            require(got.dtype == want.dtype and np.array_equal(
                np.ascontiguousarray(got).view(np.uint8), np.ascontiguousarray(want).view(np.uint8)),
                    f"run_{coll} ({form}) differs from the NumPy reference")
        emit({"reference": coll, "shape": [list(a.shape) for a in args], "forms": ["optimized", "plain"],
              "bit_exact": True})

    # ------------------------- 7. flash attention against its plain version
    B, S = PREFILL
    cfg = get_config("tinyllama-1.1b")
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    full_mcfg = get_config("mixtral-8x7b")
    mcfg = dataclasses.replace(full_mcfg, n_layers=MIXTRAL_LAYERS)
    MS = MIXTRAL_TOKENS[1]
    mixtral_case = (MIXTRAL_TOKENS[0], MS, MS, mcfg.n_heads, mcfg.n_kv_heads, mcfg.head_dim,
                    True, mcfg.sliding_window, torch.bfloat16)
    cases = [  # (B, Sq, Sk, Hq, Hkv, D, causal, window, dtype)
        (B, S, S, Hq, Hkv, D, True, None, torch.bfloat16),  # the prefill shape
        mixtral_case,  # Mixtral-8x7B's prefill shape: the window binds on half the rows
        (2, 256, 256, 8, 2, 64, True, None, torch.float32),
        (2, 192, 320, 4, 4, 96, False, None, torch.float32),  # Phi-3-mini's head_dim
        (2, 160, 160, 8, 8, 96, True, None, torch.bfloat16),
        (1, 128, 128, 4, 1, 128, True, None, torch.float32),
        (2, 200, 333, 8, 2, 64, True, 32, torch.float32),  # window, Sq != Sk, ragged
        (2, 333, 200, 8, 2, 64, True, 32, torch.bfloat16),  # rows that see no key
        (3, 1, 77, 8, 8, 64, False, None, torch.bfloat16),
    ]

    def attention_close(got, want, tol):
        """|Δ| <= tol + tol·|want| everywhere and ||Δ|| <= tol·||want||:
        whether both hold, max |Δ| and the relative rms error."""
        got, want = got.float(), want.float()
        diff = got - want
        rel = float(diff.norm() / want.norm())
        ok = bool((diff.abs() <= tol + tol * want.abs()).all()) and rel <= tol
        return ok, float(diff.abs().max()), rel

    for i, (b_, sq, sk, hq, hkv, d, causal, window, dtype) in enumerate(cases):
        tol = FLASH_TOL[str(dtype)]
        q, k, v = randn(b_, sq, hq, d).to(dtype), randn(b_, sk, hkv, d).to(dtype), \
            randn(b_, sk, hkv, d).to(dtype)
        zero_counts((flash_attention,))
        got = flash_attention(q, k, v, causal=causal, window=window)
        bodies = dict(flash_attention.body_launches)
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        require(got.dtype == dtype and bool(torch.isfinite(got).all()), "flash_attention output")
        ok, err, rel = attention_close(got, want, tol)
        require(ok, f"flash_attention off by max {err}, relative rms {rel} at "
                    f"{(b_, sq, sk, hq, hkv, d, causal, window, dtype)}")
        emit({"check": "flash_attention", "q": [b_, sq, hq, d], "kv": [b_, sk, hkv, d],
              "causal": causal, "window": window, "dtype": str(dtype), "rtol": tol, "atol": tol,
              "rel_rms_tol": tol, "max_abs_err": err, "rel_rms": rel, "bodies": bodies})
        if i == 0:
            prefill_err, prefill_qkv, prefill_want0 = err, (q, k, v), want[0]
        if cases[i] == mixtral_case:
            mixtral_err, mixtral_qkv = err, (q, k, v)
    q, k, v = prefill_qkv

    # The bf16 bound rejects a kernel with a planted fault: a materialised
    # attention on batch row 0 of the prefill shape with the causal mask off
    # by one, without the diagonal key or without the diagonal 64-key tile
    # fails it, and the same attention with the right mask passes.
    def masked_attention(q, k, v, mask):
        """q (Sq, Hq, D), k/v (Sk, Hkv, D), mask (Sq, Sk); float32 softmax,
        rows that see no key give 0."""
        G = q.shape[1] // k.shape[1]
        kf, vf = (t.float().repeat_interleave(G, dim=1) for t in (k, v))
        s = torch.einsum("qhd,khd->hqk", q.float(), kf) / q.shape[-1] ** 0.5
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1).nan_to_num(0.0)
        return torch.einsum("hqk,khd->qhd", p, vf).to(q.dtype)

    pos = torch.arange(S, device=dev)
    q_pos, k_pos = pos[:, None], pos[None, :]
    faults = {"right mask": k_pos <= q_pos, "causal mask off by one": k_pos <= q_pos + 1,
              "diagonal key dropped": k_pos < q_pos,
              "diagonal 64-key tile dropped": k_pos < q_pos // 64 * 64}
    verdicts = {}
    for name, mask in faults.items():
        ok, err, rel = attention_close(masked_attention(q[0], k[0], v[0], mask), prefill_want0,
                                       FLASH_TOL["torch.bfloat16"])
        require(ok == (name == "right mask"),
                f"the bf16 bound {'rejects' if name == 'right mask' else 'passes'} {name}: "
                f"max {err}, relative rms {rel}")
        verdicts[name] = {"passes": ok, "max_abs_err": err, "rel_rms": rel}
    emit({"check": "flash_attention bound against planted faults", "q": [1, S, Hq, D],
          "tol": FLASH_TOL["torch.bfloat16"], **verdicts})
    del prefill_want0, faults, mask
    nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2  # q and o, k and v, bf16
    b_ms, b_by = bound(nbytes, 4 * B * Hq * S * S * D / 2, BF16_FLOP_PER_S)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def host_us(fn, rounds=5, calls=20) -> float:
        """Host time of one call in µs, least over rounds of back-to-back
        calls: the card is still busy with the calls before, so this is
        the wrapper's and the launch's own cost."""
        best = float("inf")
        for _ in range(rounds):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            best = min(best, (time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        return best

    q32, k32, v32 = q.float(), k.float(), v.float()
    host = {"wgmma": host_us(lambda: flash_attention(q, k, v, causal=True)),
            "mma_sync": host_us(lambda: flash_attention(q32, k32, v32, causal=True))}
    del q32, k32, v32
    kernels["flash_attention"] = dict(
        name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:84",
        max_abs_err=prefill_err, bound_ms=b_ms, bound_by=b_by,
        ms=time_ms(lambda: flash_attention(q, k, v, causal=True), reps=10),
        plain_ms=time_ms(lambda: flash_attention_plain(q, k, v, causal=True), reps=3, warmup=1),
        library_ms=time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps=10))
    emit({"check": "flash_attention timing", "q": list(q.shape), "kv": list(k.shape),
          **{key: kernels["flash_attention"][key] for key in (
              "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
          "host_us": host, "tensor_map_host_us": host["wgmma"] - host["mma_sync"]})
    del q, k, v, qt, kt, vt, prefill_qkv, got, want
    release()

    # K4 at Mixtral's prefill shape. Its bound counts only the keys inside
    # the causal window: sum over q of min(q + 1, window) pairs, 4·D
    # operations a pair and head. The yardstick is one SDPA call given the
    # same window as a boolean mask, with the KV heads expanded beforehand.
    q, k, v = mixtral_qkv
    window = mcfg.sliding_window
    pairs = sum(min(i + 1, window) for i in range(MS))
    b_ms, b_by = bound(2 * q.numel() * 2 + 2 * k.numel() * 2,
                       4 * pairs * mcfg.head_dim * mcfg.n_heads, BF16_FLOP_PER_S)
    pos = torch.arange(MS, device=dev)
    allowed = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < window)
    G = mcfg.n_heads // mcfg.n_kv_heads
    qt = q.transpose(1, 2)
    kt, vt = (x.repeat_interleave(G, dim=2).transpose(1, 2) for x in (k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed)

    lib_err = max_abs_err(sdpa().transpose(1, 2), flash_attention(q, k, v, causal=True,
                                                                   window=window))
    mixtral_k4 = {"q": list(q.shape), "kv": list(k.shape), "window": window,
                  "max_abs_err": mixtral_err, "key_pairs": pairs,
                  "ms": time_ms(lambda: flash_attention(q, k, v, causal=True, window=window),
                                reps=10),
                  "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v, causal=True,
                                                                    window=window),
                                      reps=3, warmup=1),
                  "library_ms": time_ms(sdpa, reps=10), "bound_ms": b_ms, "bound_by": b_by,
                  "library": "SDPA, boolean window mask, KV heads expanded",
                  "library_max_abs_err_vs_kernel": lib_err}
    kernels["flash_attention"]["mixtral_shape"] = mixtral_k4
    emit({"check": "flash_attention timing, Mixtral-8x7B shape", **mixtral_k4})
    del q, k, v, qt, kt, vt, mixtral_qkv, allowed, pos
    release()

    # ------------------------------- 8. TinyLlama-1.1B prefill at full width
    all_counters = counters + (flash_attention,)
    params = M.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, device=dev)
    tokens = torch.randint(1, cfg.vocab, PREFILL, generator=gen, device=dev)
    batch = {"tokens": tokens, "labels": tokens}

    def model_run(fn, *args):
        """Run fn with every launch count at 0; return its result and the counts."""
        zero_counts(all_counters)
        out = fn(*args)
        torch.cuda.synchronize()
        return out, {c.__name__: c.launches for c in all_counters}

    def logits_close(got, want, what):
        got, want = got.float(), want.float()
        err = max_abs_err(got, want)
        rel = float((got - want).norm() / want.norm())
        require(bool(torch.isfinite(got).all()), f"{what}: non-finite logits")
        require(err <= LOGIT_MAX_ABS and rel <= LOGIT_REL_RMS,
                f"{what}: logits off by max {err}, relative rms {rel}")
        return err, rel

    only_k4 = {name: 0 for name in launches} | {"flash_attention": cfg.n_layers}
    torch.cuda.reset_peak_memory_stats()
    (logits, _, _), counts = model_run(M.forward_train, params, batch, cfg, True)
    prefill_peak = torch.cuda.max_memory_allocated() / 2**30
    require(counts == only_k4, f"forward_train launched {counts}, expected {only_k4}")
    bodies = dict(flash_attention.body_launches)  # the prefill shape takes the wgmma body
    require(bodies == {"mma_sync": 0, "wgmma": cfg.n_layers},
            f"forward_train launched flash_attention's bodies {bodies}")
    launches["flash_attention"] = counts["flash_attention"]
    kernels["flash_attention"].update(body="wgmma", body_launches=bodies)
    last = logits[:, -1].float()
    del logits
    (loss, metrics), counts = model_run(M.loss_fn, params, batch, cfg, True)
    require(counts == only_k4, f"loss_fn launched {counts}, expected {only_k4}")
    require(bool(torch.isfinite(loss)), f"loss is {float(loss)}")
    (naive, _, _), counts = model_run(M.forward_train, params, batch, cfg, False)
    require(counts["flash_attention"] == 0, "the naive forward launched flash_attention")
    naive_last = naive[:, -1].float()
    del naive
    release()
    naive_loss = M.loss_fn(params, batch, cfg, False)[0]
    err, rel = logits_close(last, naive_last, "kernel vs naive forward")
    loss_rel = abs(float(loss) - float(naive_loss)) / abs(float(naive_loss))
    require(loss_rel <= LOSS_REL, f"loss {float(loss)} vs naive {float(naive_loss)}")
    fwd_ms = time_ms(lambda: M.forward_train(params, batch, cfg, True), reps=3, warmup=1)
    runs.append({"run": "prefill", "model": cfg.name, "tokens": list(PREFILL),
                 "launches": {"flash_attention": cfg.n_layers}, "flash_attention_bodies": bodies,
                 "ms": fwd_ms,
                 "tokens_per_s": B * S / fwd_ms * 1e3, "peak_gib": prefill_peak,
                 "loss": float(loss), "naive_loss": float(naive_loss),
                 "last_logits_vs_naive": {"max_abs_err": err, "rel_rms": rel}})
    emit(runs[-1])
    del last, naive_last
    release()

    # --------------------------------- 9. serving at full width, 4 slots
    class Recording(Engine):
        """The engine, keeping each step's positions and logits."""

        def _forward(self):
            out = super()._forward()
            self.trace.append((self.positions.copy(), out))
            return out

    rng = np.random.default_rng(SEED)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, size=rng.integers(3, 9)).astype(np.int32),
                    max_new_tokens=12) for i in range(6)]
    torch.cuda.reset_peak_memory_stats()
    eng = Recording(cfg, params, batch_slots=4, max_seq=2048, device=dev)
    eng.trace = []
    zero_counts(all_counters)
    pending = list(reqs)
    t0 = time.perf_counter()
    while pending or eng.slot_req:
        while pending and eng.free_slots:
            eng.admit(pending.pop(0))
        eng.step()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    serve_counts = {c.__name__: c.launches for c in all_counters}
    require(all(r.done and len(r.out) == 12 for r in reqs),
            f"requests not answered: {[(r.rid, r.done, len(r.out)) for r in reqs]}")
    require(eng.tokens_out == 72, f"engine committed {eng.tokens_out} tokens, expected 72")
    p0 = reqs[0].prompt  # request 0 sits in slot 0
    step_logits = next(out[0] for pos, out in eng.trace if pos[0] == len(p0) - 1)
    full = M.forward_train(params, {"tokens": torch.from_numpy(p0).to(dev)[None]}, cfg, True)[0]
    err, rel = logits_close(torch.from_numpy(step_logits).to(dev), full[0, -1],
                            "decode vs prefill logits")
    runs.append({"run": "serve", "model": cfg.name, "slots": 4, "max_seq": 2048,
                 "requests": len(reqs), "prompt_lens": [len(r.prompt) for r in reqs],
                 "steps": eng.steps_run, "tokens": eng.tokens_out, "s": serve_s,
                 "tokens_per_s": eng.tokens_out / serve_s, "peak_gib": serve_peak,
                 "launches": serve_counts,
                 "decode_vs_prefill_logits": {"max_abs_err": err, "rel_rms": rel}})
    emit(runs[-1])
    del full
    release()

    # ---------------------------- 10. where the model path's device time goes
    def device_profile(fn, wall_ms, reps=3, labels=(), top_ops=0):
        """Device time per call by kernel group, from torch.profiler, beside
        a wall time taken without the profiler; the idle share is the part
        of the wall time with no kernel running (None where the profiler
        saw no device time). With ``labels``, also the device time of the
        kernels launched inside each ``record_function`` range of that
        name (the ranges' own device spans are not kernels and are left
        out of the groups); with ``top_ops``, the device time of the kernels
        each torch op launches itself, for the ops with the most."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        groups, n_kernels = {}, 0
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA or e.key in labels:
                continue
            name = e.key.lower()
            group = ("flash_attention" if "flash_attention" in name else
                     "matmul" if any(w in name for w in ("gemm", "gemv", "cutlass", "xmma", "nvjet"))
                     else "other")
            groups[group] = groups.get(group, 0.0) + e.self_device_time_total / 1e3 / reps
            n_kernels += e.count
        busy = sum(groups.values())
        rec = {"wall_ms": wall_ms, "device_ms": busy, "kernels_per_call": n_kernels / reps,
               "idle_share": 1 - busy / wall_ms if busy else None, "device_ms_by_group": groups}
        if top_ops:
            own = sorted(((e.self_device_time_total / 1e3 / reps, e.key)
                          for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CPU
                          and e.self_device_time_total > 0), reverse=True)
            rec["device_ms_by_op"] = {key: ms for ms, key in own[:top_ops]}
        if labels:
            by_label = dict.fromkeys(labels, 0.0)
            for e in prof.events():
                if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
                    continue
                up = e
                while up is not None and up.name not in by_label:
                    up = up.cpu_parent
                if up is not None:
                    by_label[up.name] += sum(k.duration for k in e.kernels) / 1e3 / reps
            rec["device_ms_by_label"] = by_label
        return rec

    step_ms = time_ms(eng._forward, reps=5, warmup=1)
    emit({"profile": "prefill forward", **device_profile(
        lambda: M.forward_train(params, batch, cfg, True), fwd_ms)})
    emit({"profile": "engine step, 4 slots", **device_profile(eng._forward, step_ms)})
    del params, eng, batch
    release()

    # ----------------- 11. Mixtral-8x7B at full width, the depth cut to 8 layers
    t0 = time.perf_counter()
    mparams = M.init_params(torch.Generator(device=dev).manual_seed(SEED), mcfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def tensors(tree):
        if isinstance(tree, torch.Tensor):
            yield tree
            return
        for sub in tree.values() if isinstance(tree, dict) else tree:
            yield from tensors(sub)

    n_params = sum(t.numel() for t in tensors(mparams))
    weight_gb = sum(t.numel() * t.element_size() for t in tensors(mparams)) / 1e9
    print(f"mixtral-8x7b: depth cut from {full_mcfg.n_layers} to {mcfg.n_layers} layers: all "
          f"{full_mcfg.n_layers} take {full_mcfg.param_count() * 2 / 1e9:.1f} GB of bf16 "
          f"weights, more than the card holds; {mcfg.n_layers} layers: {n_params / 1e9:.2f} B "
          f"parameters, {weight_gb:.1f} GB (made on the card in {init_s:.1f} s); every width "
          "is the published one", flush=True)
    mtokens = torch.randint(1, mcfg.vocab, MIXTRAL_TOKENS, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(SEED))
    mbatch = {"tokens": mtokens, "labels": mtokens}
    T_m = mtokens.numel()
    only_k4 = {name: 0 for name in launches} | {"flash_attention": mcfg.n_layers}
    torch.cuda.reset_peak_memory_stats()
    with MOE.recording_routes() as k_routes:
        (logits, aux, _), counts = model_run(M.forward_train, mparams, mbatch, mcfg, True)
    kernel_peak = torch.cuda.max_memory_allocated() / 2**30
    require(counts == only_k4, f"mixtral forward_train launched {counts}, expected {only_k4}")
    m_launches = counts["flash_attention"]
    m_bodies = dict(flash_attention.body_launches)
    require(m_bodies == {"mma_sync": 0, "wgmma": mcfg.n_layers},
            f"mixtral forward_train launched flash_attention's bodies {m_bodies}")
    require(len(k_routes) == mcfg.n_layers and bool(torch.isfinite(aux)),
            f"{len(k_routes)} MoE layers routed, aux {float(aux)}")
    last = logits[:, -1].float()
    del logits
    (loss, metrics), counts = model_run(M.loss_fn, mparams, mbatch, mcfg, True)
    require(counts == only_k4, f"mixtral loss_fn launched {counts}, expected {only_k4}")
    require(bool(torch.isfinite(loss)) and "moe_aux" in metrics, f"mixtral loss {float(loss)}")
    release()
    torch.cuda.reset_peak_memory_stats()
    with MOE.recording_routes() as n_routes:
        (naive, naive_aux, _), counts = model_run(M.forward_train, mparams, mbatch, mcfg, False)
    naive_peak = torch.cuda.max_memory_allocated() / 2**30
    require(counts["flash_attention"] == 0, "the naive mixtral forward launched flash_attention")
    naive_last = naive[:, -1].float()
    del naive
    release()
    naive_loss = M.loss_fn(mparams, mbatch, mcfg, False)[0]
    release()
    err, rel = logits_close(last, naive_last, "mixtral: kernel vs naive forward")
    loss_rel = abs(float(loss) - float(naive_loss)) / abs(float(naive_loss))
    require(loss_rel <= LOSS_REL, f"mixtral loss {float(loss)} vs naive {float(naive_loss)}")
    # (layer, token) routes that differ between the passes: in any order,
    # as a set, and first for the token (before it, the token's routes
    # agreed in every layer); for the first ones, the kernel pass's gap
    # between the router probabilities of ranks k and k + 1 or k - 1 and k
    diff = torch.stack([(a != b).any(-1) for (a, *_), (b, *_) in zip(k_routes, n_routes)])
    set_diff = torch.stack([(a.sort(-1)[0] != b.sort(-1)[0]).any(-1)
                            for (a, *_), (b, *_) in zip(k_routes, n_routes)])
    first = diff & (diff.int().cumsum(0) == 1)
    k = mcfg.moe.top_k
    probs = torch.stack([torch.softmax(lg.float(), -1).sort(-1, descending=True)[0]
                         for _, _, lg in k_routes])  # (L, T, E)
    gap = (probs[..., :k + 1].diff(dim=-1).abs()).amin(-1)  # nearest boundary among ranks 1..k+1
    flip_share = float(diff.float().mean())
    flips = {"share": flip_share, "set_share": float(set_diff.float().mean()),
             "by_layer": diff.sum(1).tolist(), "first_by_layer": first.sum(1).tolist(),
             "tokens_ever": int(diff.any(0).sum()),
             "first_gap_median": float(gap[first].median()) if first.any() else None,
             "first_gap_max": float(gap[first].max()) if first.any() else None,
             "all_gap_median": float(gap.median())}
    kept = [keep for _, keep, _ in k_routes]
    drop_share = sum(int((~keep).sum()) for keep in kept) / sum(keep.numel() for keep in kept)
    drops_by_layer = [int((~keep).sum()) for keep in kept]
    del k_routes, n_routes, kept, last, naive_last, probs, gap, diff, set_diff, first
    release()
    m_fwd_ms = time_ms(lambda: M.forward_train(mparams, mbatch, mcfg, True), reps=3, warmup=1)
    labels = ("moe.dispatch", "moe.experts", "moe.combine")
    mprof = device_profile(lambda: M.forward_train(mparams, mbatch, mcfg, True), m_fwd_ms,
                           labels=labels, top_ops=16)
    lab = mprof["device_ms_by_label"]
    k4_ms = mprof["device_ms_by_group"].get("flash_attention", 0.0)
    if lab["moe.experts"]:  # kernels were traced back to their torch ops
        dc_ms = lab["moe.dispatch"] + lab["moe.combine"]
        mprof["device_ms_by_part"] = {
            "expert products (moe.experts: 3 bmm and the gate)": lab["moe.experts"],
            "dispatch and combine (router included)": dc_ms, "flash_attention (K4)": k4_ms,
            "the rest": mprof["device_ms"] - lab["moe.experts"] - dc_ms - k4_ms}
    else:
        mprof["device_ms_by_part"] = "not measured: the profiler tied no kernel to a torch op"
    C_m = MOE.capacity(mcfg, T_m)
    launches["flash_attention"] += m_launches
    kernels["flash_attention"]["launches_by_path"] = {
        f"{cfg.name} prefill": cfg.n_layers, f"{mcfg.name} prefill": m_launches}
    kernels["flash_attention"]["body_launches"] = {
        body: kernels["flash_attention"]["body_launches"][body] + m_bodies[body]
        for body in m_bodies}
    runs.append({"run": "prefill", "model": mcfg.name, "layers": f"{mcfg.n_layers} of "
                 f"{full_mcfg.n_layers}", "tokens": list(MIXTRAL_TOKENS), "params": n_params,
                 "launches": {"flash_attention": mcfg.n_layers}, "flash_attention_bodies": m_bodies,
                 "ms": m_fwd_ms, "tokens_per_s": T_m / m_fwd_ms * 1e3,
                 "peak_gib": {"kernel": kernel_peak, "naive": naive_peak},
                 "loss": float(loss), "naive_loss": float(naive_loss), "moe_aux": float(aux),
                 "naive_moe_aux": float(naive_aux),
                 "last_logits_vs_naive": {"max_abs_err": err, "rel_rms": rel},
                 "capacity": C_m, "dropped_share": drop_share, "dropped_by_layer": drops_by_layer,
                 "route_flips": flips, "profile": mprof})
    emit(runs[-1])
    del loss, metrics, naive_loss, aux, naive_aux
    release()

    rng = np.random.default_rng(SEED)
    mreqs = [Request(rid=i, prompt=rng.integers(1, mcfg.vocab, size=rng.integers(3, 9))
                     .astype(np.int32), max_new_tokens=12) for i in range(6)]
    torch.cuda.reset_peak_memory_stats()
    meng = Recording(mcfg, mparams, batch_slots=4, max_seq=128, device=dev)
    meng.trace = []
    zero_counts(all_counters)
    pending = list(mreqs)
    t0 = time.perf_counter()
    while pending or meng.slot_req:
        while pending and meng.free_slots:
            meng.admit(pending.pop(0))
        meng.step()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    require(all(r.done and len(r.out) == 12 for r in mreqs),
            f"mixtral requests not answered: {[(r.rid, r.done, len(r.out)) for r in mreqs]}")
    require(meng.tokens_out == 72, f"mixtral engine committed {meng.tokens_out} tokens")
    p0 = mreqs[0].prompt
    step_logits = next(out[0] for pos, out in meng.trace if pos[0] == len(p0) - 1)
    full = M.forward_train(mparams, {"tokens": torch.from_numpy(p0).to(dev)[None]}, mcfg, True)[0]
    err, rel = logits_close(torch.from_numpy(step_logits).to(dev), full[0, -1],
                            "mixtral decode vs prefill logits")
    runs.append({"run": "serve (smoke)", "model": mcfg.name, "layers": mcfg.n_layers, "slots": 4,
                 "max_seq": 128, "requests": len(mreqs),
                 "prompt_lens": [len(r.prompt) for r in mreqs], "steps": meng.steps_run,
                 "tokens": meng.tokens_out, "s": serve_s,
                 "smoke_tokens_per_s": meng.tokens_out / serve_s,
                 "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                 "launches": {c.__name__: c.launches for c in all_counters},
                 "decode_vs_prefill_logits": {"max_abs_err": err, "rel_rms": rel}})
    emit(runs[-1])
    del mparams, meng, mbatch, mtokens, full
    release()
    require(flip_share < ROUTE_FLIP_MAX and (flips["first_gap_max"] or 0) < FIRST_FLIP_GAP_MAX,
            f"mixtral: {flip_share:.4%} of (token, layer) routes differ between the kernel and "
            f"naive passes, or one first differs away from a near-tie: {flips}")

    # ------------------------ 12. the per-shard all-reduce, 8 ranks on the card
    for name, rec in kernels.items():
        rec["launches"] = launches[name]
    kernels["ring_exchange"] = per_shard_phase(dev, SEED)

    # --------------------------------------------------------------- report
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("body", "body_launches", "acc_launches", "body_ms", "combine_hook_ms",
             "combine_hook_bound_ms", "ffma_bound_ms", "tf32x3_route_bound_ms",
             "launches_by_path", "mixtral_shape")
    print(card, flush=True)
    emit({"kernels": [{key: rec[key] for key in keys + extra if key in rec or key in keys}
                      for rec in kernels.values()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
