"""Process groups in router order: the per-shard counterpart of a mesh.

``make_dragonfly_group(rank, n)`` joins this process to a group of n ranks
whose rank order IS the router order of ``dragonfly_layout(n)``: programs
lowered from the IR (``runtime.lowering``) replay on it verbatim through the
per-shard ``dragonfly_*`` collectives (``dist.collectives``) and the
backend ``dragonfly_runtime_backend`` returns. ``spawn(fn, n)`` starts the n
ranks as processes of one host, which is how the tests run them on the CPU
(gloo, ``device="cpu"``) and ``chip_smoke.py`` runs them on one card.

The transport is chosen, returned (``torch.distributed.get_backend`` of the
group) and printed by rank 0: gloo for ranks on the CPU; on the card NCCL
where every rank has a card of its own, and gloo where ranks share a card,
because NCCL refuses two ranks on one device. Rank r's tensors live on
``rank_device(r, device)``.
"""

from __future__ import annotations

import datetime
import pathlib
import pickle
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.dist.mesh import dragonfly_layout

#: How long a rank waits in a collective of its group before it raises.
GROUP_TIMEOUT_S = 300.0


def dragonfly_runtime_backend(name: str = "torch_dist", *, overlap: bool = False):
    """The runtime backend launchers replay programs with. ``overlap=True``
    orders stages by ``start_step`` so pipelined rounds interleave;
    ``name="reference"`` gives the device-free NumPy replay."""
    from repro_torch.runtime.backends import get_backend

    kwargs = {"overlap": overlap} if name == "torch_dist" else {}
    return get_backend(name, **kwargs)


def rank_device(rank: int, device: str = "cuda") -> torch.device:
    """Where rank ``rank``'s tensors live: the CPU, or card
    ``rank % torch.cuda.device_count()``. Raises where there is no card."""
    kind = torch.device(device).type
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"dragonfly groups run on 'cuda' or 'cpu', not {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("a dragonfly group on the card needs a CUDA card and found none; "
                           "pass device='cpu' for gloo ranks on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_dragonfly_group(rank: int, n: int, *, device: str = "cuda", init_method: str):
    """Join this process, as ``rank``, to a group of ``n`` ranks in router
    order (``init_method``: a ``file://`` or ``tcp://`` rendezvous). Returns
    ``(group, layout)`` with ``layout = dragonfly_layout(n)``."""
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        shared = torch.cuda.device_count() < n
        transport = "gloo" if shared else "nccl"
        why = (f"{n} ranks share {torch.cuda.device_count()} card(s)" if shared
               else "every rank has a card of its own")
    else:
        transport, why = "gloo", "ranks on the CPU"
    dist.init_process_group(transport, init_method=init_method, rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    dist.barrier()
    if rank == 0:
        print(f"dragonfly group: {n} ranks over {transport} ({why})", flush=True)
    return dist.group.WORLD, dragonfly_layout(n)


def _run_rank(rank: int, fn, n: int, device: str, root: str, args) -> None:
    group, layout = make_dragonfly_group(rank, n, device=device,
                                         init_method=f"file://{root}/rendezvous")
    try:
        result = fn(rank, group, layout, *args)
        (pathlib.Path(root) / f"rank{rank}.pkl").write_bytes(pickle.dumps(result))
    finally:
        dist.destroy_process_group()


def spawn(fn, n: int, *, device: str = "cuda", args=()) -> list:
    """Run ``fn(rank, group, layout, *args)`` on ``n`` ranks, one process
    each, joined by a file store in a temporary directory (no ports), and
    return each rank's result in rank order (results are pickled: return
    host data). ``fn`` must be importable by the children. A rank that
    raises fails the call: the others are stopped and the error is raised
    here."""
    with tempfile.TemporaryDirectory(prefix="dragonfly-group-") as root:
        mp.spawn(_run_rank, args=(fn, n, device, root, tuple(args)), nprocs=n, join=True)
        return [pickle.loads((pathlib.Path(root) / f"rank{r}.pkl").read_bytes())
                for r in range(n)]
