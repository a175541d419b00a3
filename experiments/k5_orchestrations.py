"""Compare two orchestrations of the same K5 kernels (csrc/ring_exchange.cu)
on N ranks with 25 MiB each, in one run: "spin" (put, signal, then a wait
that spins for its flag) and "barrier" (put, signal, a stream sync and a
group barrier, then a wait whose flag is already set), beside "library",
``CudaFusedBackend.allreduce_shard``, which takes the barrier where ranks
share a card and spins where each has its own. Ranks go to the cards round
robin (``launch.mesh.rank_device``): N ranks on one card share it
(time-sliced, a gloo group); N ranks on N cards each have their own (NVLink,
an NCCL group). All three are held bit for bit against the rounds' sums
computed on the card from every rank's data. Order: spin, barrier,
library, library, barrier, spin, 10 calls each; prints the card's name and
power limit, then each rank's medians and a bare group barrier's. Needs a
CUDA card:

    python experiments/k5_orchestrations.py [--ranks N]   # N = 8 by default
"""
import argparse
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
BUCKET = 6553600
REPS = 10


def rank_fn(rank, group, layout):
    import torch
    import torch.distributed as dist
    from repro_torch.dist import collectives as dc
    from repro_torch.launch.mesh import rank_device
    from repro_torch.runtime.backends import cuda_fused as cf

    dev = rank_device(rank)
    prog = dc.allreduce_program(layout)
    be = cf.CudaFusedBackend()
    xs = [torch.randn(BUCKET, generator=torch.Generator(device=dev).manual_seed(r), device=dev)
          for r in range(layout.n)]
    partners = cf.ring_partners(prog)
    want = xs
    for table in partners:  # every rank's sum of each round: x + x_partner
        want = [want[j] + want[int(table[j])] for j in range(layout.n)]
    x, want = xs[rank], want[rank]
    del xs
    window = cf.ring_window(group, x, prog)

    def call(sync: bool):
        window.epoch += 1
        val = x
        for r, table in enumerate(partners):
            p = int(table[rank])
            cf.ring_put(val, window, r, p)
            cf.ring_signal(window, r, p)
            if sync:
                torch.cuda.current_stream().synchronize()
                dist.barrier(group=group)
            val = cf.ring_wait_add(val, window, r, p)
        window.check()
        return val

    def spin():
        return call(False)

    def barrier():
        return call(True)

    def library():
        return be.allreduce_shard(x, group, prog)

    for fn in (spin, barrier, library):
        assert torch.equal(fn().view(torch.int32), want.view(torch.int32)), \
            f"rank {rank}: {fn.__name__} differs from the rounds' sums"
    times = {"spin": [], "barrier": [], "library": [], "group_barrier": []}
    for fn in (spin, barrier, library, library, barrier, spin):
        for _ in range(REPS):
            dist.barrier()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[fn.__name__].append((time.perf_counter() - t0) * 1e3)
    for _ in range(REPS):
        t0 = time.perf_counter()
        dist.barrier()
        times["group_barrier"].append((time.perf_counter() - t0) * 1e3)
    shared = window.shared
    cf.close_ring_windows(group)
    return {"transport": dist.get_backend(group), "device": str(dev),
            "library_takes": "barrier" if shared else "spin",
            **{k: statistics.median(v) for k, v in times.items()}}


if __name__ == "__main__":
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import spawn

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ranks", type=int, default=8)
    ranks = parser.parse_args().ranks
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    build.build_all(("ring_exchange",))  # the ranks only load it
    res = spawn(rank_fn, ranks, device="cuda")
    print(f"{ranks} ranks over {res[0]['transport']} on",
          sorted({r["device"] for r in res}), "25 MiB each; the library takes",
          res[0]["library_takes"], flush=True)
    for key in ("spin", "barrier", "library", "group_barrier"):
        vals = [r[key] for r in res]
        print(key, "per-rank median ms", vals, "median", statistics.median(vals), flush=True)
