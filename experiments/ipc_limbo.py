"""Show what keeps a parent's CUDA tensors alive after the ranks it handed
them to by CUDA IPC have exited, and what frees them. Needs a CUDA card:

    python experiments/ipc_limbo.py

Four rounds, each: the parent makes a 2 GiB bf16 tensor, hands it to 4
ranks (``launch.mesh.spawn``, the tensor in a dict among the ranks'
arguments), each rank reads it, then either keeps its reference to the
end of the process (``clear=False``) or empties the dict before its
function returns (``clear=True``); the parent then drops the tensor,
calls ``torch.cuda.ipc_collect()`` and ``empty_cache()`` and prints the
memory torch still counts as allocated and the card's free memory. A rank
that keeps its reference to exit never releases torch's IPC counter, so
the parent's block stays in limbo until the parent exits.
"""
import gc
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "experiments"))

import torch  # noqa: E402

GIB = 2**30


def rank_fn(rank, group, layout, shared, clear):
    t = shared["w"]
    s = float(t[:4].float().sum())
    del t
    if clear:
        shared.clear()
        gc.collect()
    return s


def main():
    import ipc_limbo
    from repro_torch.launch.mesh import spawn

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for clear in (False, True, False, True):
        w = torch.ones(GIB, device="cuda", dtype=torch.bfloat16)
        shared = {"w": w}
        spawn(ipc_limbo.rank_fn, 4, device="cuda", args=(shared, clear))
        del w, shared
        torch.cuda.synchronize()
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()
        print(f"clear={clear}: allocated {torch.cuda.memory_allocated() / GIB:.2f} GiB, "
              f"free {torch.cuda.mem_get_info()[0] / GIB:.2f} GiB", flush=True)


if __name__ == "__main__":
    main()
