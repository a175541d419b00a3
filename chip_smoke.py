#!/usr/bin/env python3
"""Drive the port's collective runtime on one NVIDIA card, end to end.

    python3 chip_smoke.py

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``src/repro_torch/csrc`` and prints the
   build time and the compiler's register and spill report;
3. holds each kernel against its plain torch version on the card, at the
   shapes the main path gives it: reduce_rounds and combine_rows
   bit-exact, block_matmul exact on integer-valued inputs and within
   rtol = atol = 2e-4 on random-normal ones (the summation order differs);
4. drives the four collectives at full width through the user's entry
   points (``dist.collectives.*_program``, then
   ``runtime.backends.get_backend("cuda_fused").run_*``) and holds each,
   bit for bit, against the port's plain torch path on the card, counting
   every kernel launch;
5. holds all four, at a reduced width, against the port's NumPy
   ``reference`` backend, bit for bit;
6. times every kernel and collective with CUDA events (median of several
   runs after a warm-up) beside its bound, the least time the card could
   take: the larger of bytes moved over 3.35 TB/s and operations over the
   float32 (non-tensor-core) rate of 67 TFLOP/s, the H100 SXM data-sheet
   peaks at 700 W.

Float32 matrix products run in full float32: TF32 is switched off for
cuBLAS and cuDNN. Every failure raises and exits non-zero before the last
line, which is ``{"ok": true, "device": {...}}``. Without a card the
script exits non-zero at once: it has no CPU path.

The cells (layout D3(K, M) has n = K·M² routers):

  all-to-all  D3(4,4), n = 64, x (64, 64, 262144) f32: 1 MiB per (src, dst)
              chunk, 64 tokens × 4096 d_model of an MoE dispatch;
  all-reduce  D3(4,4), x (64, 6553600) f32: 25 MiB per router, PyTorch
              DDP's default gradient bucket;
  broadcast   D3(4,4) from root 0, the same 25 MiB per router;
  matmul      grid (4,4) = D3(16,4), n = 256, X = 512: B, A 8192 × 8192 f32
              with integer entries in [-4, 4], so B @ A is exact.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
SEED = 0
CHUNK = 262144  # all-to-all: floats per (src, dst) chunk, 1 MiB
BUCKET = 6553600  # all-reduce and broadcast: floats per router, 25 MiB
BLOCK = 512  # matmul: X, the side of each router's block


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA card; this script runs the "
                 "port on the card and has no CPU path")
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

    import numpy as np

    from repro_torch.core.matmul import MatmulGrid
    from repro_torch.dist import collectives as dc
    from repro_torch.dist.mesh import dragonfly_layout
    from repro_torch.kernels import build
    from repro_torch.kernels.block_matmul.block_matmul import block_matmul
    from repro_torch.kernels.block_matmul.ref import block_matmul_ref
    from repro_torch.runtime import optimize as opt
    from repro_torch.runtime.backends import get_backend
    from repro_torch.runtime.backends import cuda_fused as cf

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

    def time_ms(fn, reps=5, warmup=2) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        return statistics.median(times)

    def bound(nbytes: float, flops: float) -> tuple[float, str]:
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
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

    t = opt.to_device_tables(opt.allreduce_tables(progs["allreduce"]), dev)
    x = randn(n, F)
    got, want = cf.reduce_rounds(x, t["gather"], t["mask"]), cf._reduce_rounds_plain(x, t["gather"], t["mask"])
    require(same_bits(got, want), "reduce_rounds differs from its plain version")
    R, k = t["gather"].shape[:2]
    allreduce_ops = R * (k + 1) * n * F  # k selected adds and the self-add per round
    b_ms, b_by = bound(2 * n * F * 4 + R * k * n * 5, allreduce_ops)
    kernels["reduce_rounds"] = dict(
        name="reduce_rounds", route="cuda", source="src/repro_torch/csrc/reduce_rounds.cu",
        replaces="src/repro/runtime/backends/pallas_fused.py:133",
        max_abs_err=max_abs_err(got, want), bound_ms=b_ms, bound_by=b_by,
        ms=time_ms(lambda: cf.reduce_rounds(x, t["gather"], t["mask"])),
        plain_ms=time_ms(lambda: cf._reduce_rounds_plain(x, t["gather"], t["mask"])),
        library_ms=None)
    emit({"check": "reduce_rounds", "shape": [n, F], "tables": [R, k, n], "bit_exact": True,
          **{key: kernels["reduce_rounds"][key] for key in ("ms", "plain_ms", "bound_ms")}})
    del x, got, want
    release()

    groups = [tabs for kind_, _, tabs in opt.matmul_tables(progs["matmul"]) if kind_ == "combine"]
    require(len(groups) == 32, f"expected 32 combine groups at grid (4,4), got {len(groups)}")
    val = randn(n_mm, X * X)
    err, widths = 0.0, set()
    for tabs in groups[:2]:  # one round's two groups (k = 5 and k = 4)
        t = opt.to_device_tables(tabs, dev)
        got, want = cf.combine_rows(val, t["gather"], t["mask"]), cf._combine_rows_plain(val, t["gather"], t["mask"])
        require(same_bits(got, want), "combine_rows differs from its plain version")
        err, widths = max(err, max_abs_err(got, want)), widths | {t["gather"].shape[0]}
    k = t["gather"].shape[0]
    b_ms, b_by = bound(2 * n_mm * X * X * 4 + k * n_mm * 5, k * n_mm * X * X)
    kernels["combine_rows"] = dict(
        name="combine_rows", route="cuda", source="src/repro_torch/csrc/reduce_rounds.cu",
        replaces="src/repro/runtime/backends/pallas_fused.py:161",
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        ms=time_ms(lambda: cf.combine_rows(val, t["gather"], t["mask"]), reps=20),
        plain_ms=time_ms(lambda: cf._combine_rows_plain(val, t["gather"], t["mask"]), reps=20),
        library_ms=None)
    emit({"check": "combine_rows", "shape": [n_mm, X * X], "k": sorted(widths), "bit_exact": True,
          **{key: kernels["combine_rows"][key] for key in ("ms", "plain_ms", "bound_ms")}})
    del val, got, want
    release()

    a, b = randint(n_mm, X, X), randint(n_mm, X, X)
    require(same_bits(block_matmul(a, b), block_matmul_ref(a, b)),
            "block_matmul is not exact on integer-valued inputs")
    a, b = randn(n_mm, X, X), randn(n_mm, X, X)
    got, want = block_matmul(a, b), block_matmul_ref(a, b)
    require(torch.allclose(got, want, rtol=2e-4, atol=2e-4),
            f"block_matmul off by {max_abs_err(got, want)} on random-normal inputs")
    b_ms, b_by = bound(3 * n_mm * X * X * 4, 2 * n_mm * X ** 3)
    kernels["block_matmul"] = dict(
        name="block_matmul", route="cuda", source="src/repro_torch/csrc/block_matmul.cu",
        replaces="src/repro/kernels/block_matmul/block_matmul.py:46",
        max_abs_err=max_abs_err(got, want), bound_ms=b_ms, bound_by=b_by,
        ms=time_ms(lambda: block_matmul(a, b)),
        plain_ms=time_ms(lambda: block_matmul_ref(a, b)),
        library_ms=time_ms(lambda: torch.bmm(a, b)))
    emit({"check": "block_matmul", "shape": [n_mm, X, X], "exact_on_integers": True,
          "rtol": 2e-4, "atol": 2e-4,
          **{key: kernels["block_matmul"][key] for key in ("max_abs_err", "ms", "plain_ms",
                                                           "library_ms", "bound_ms")}})
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
        for fn in counters:
            fn.launches = 0
        got = run[coll](*args)
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in counters}
        require(counts == {name: expected[coll].get(name, 0) for name in counts},
                f"run_{coll} launched {counts}, expected {expected[coll]}")
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

    # --------------------------------------------------------------- report
    for name, rec in kernels.items():
        rec["launches"] = launches[name]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card, flush=True)
    emit({"kernels": [{key: rec[key] for key in keys} for rec in kernels.values()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
