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

``make_mesh(shape, axes)`` lays the ranks of the world out as a mesh of
processes, row-major with the last axis fastest, and builds the process
group of each axis (``ProcessMesh``): the per-rank counterpart of the JAX
package's device mesh, which ``dist.sharding.set_active`` registers.
``make_production_mesh`` and ``make_rules`` are the production layouts
and rules of ``repro.launch.mesh``.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import pathlib
import pickle
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.dist.mesh import dragonfly_layout
from repro_torch.dist.sharding import ShardRules

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
    """Where rank ``rank``'s tensors live: the CPU, the meta device (shapes
    and dtypes only, for the dry run's fake world), or card
    ``rank % torch.cuda.device_count()``. Raises where there is no card."""
    kind = torch.device(device).type
    if kind in ("cpu", "meta"):
        return torch.device(kind)
    if kind != "cuda":
        raise ValueError(f"dragonfly groups run on 'cuda', 'cpu' or 'meta', not {device!r}")
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
    # NCCL is told the rank's card, so it need not guess it from the rank
    bound = {"device_id": dev} if transport == "nccl" else {}
    dist.init_process_group(transport, init_method=init_method, rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S), **bound)
    dist.barrier()
    if rank == 0:
        print(f"dragonfly group: {n} ranks over {transport} ({why})", flush=True)
    return dist.group.WORLD, dragonfly_layout(n)


def _run_rank(rank: int, fn, n: int, device: str, root: str, args) -> None:
    # each rank takes its share of the host's cores for torch's intra-op
    # threads: n pools of every core oversubscribe the host, and a gloo
    # exchange of a few KB then took 25 ms instead of 0.4 (8 ranks, 8 cores)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    group, layout = make_dragonfly_group(rank, n, device=device,
                                         init_method=f"file://{root}/rendezvous")
    try:
        result = fn(rank, group, layout, *args)
        (pathlib.Path(root) / f"rank{rank}.pkl").write_bytes(pickle.dumps(result))
        dist.barrier()  # no rank tears its transport down while a peer still reads from it
    finally:
        dist.destroy_process_group()


def spawn(fn, n: int, *, device: str = "cuda", args=()) -> list:
    """Run ``fn(rank, group, layout, *args)`` on ``n`` ranks, one process
    each, joined by a file store in a temporary directory (no ports), and
    return each rank's result in rank order (results are pickled: return
    host data). ``fn`` must be importable by the children. Each rank runs
    torch's intra-op work on cpu_count // n threads. A rank that raises
    fails the call: the others are stopped and the error is raised
    here."""
    with tempfile.TemporaryDirectory(prefix="dragonfly-group-") as root:
        mp.spawn(_run_rank, args=(fn, n, device, root, tuple(args)), nprocs=n, join=True)
        return [pickle.loads((pathlib.Path(root) / f"rank{r}.pkl").read_bytes())
                for r in range(n)]


# ------------------------------------------------------------ process meshes
def carrier_device(transport: str, device: torch.device) -> torch.device:
    """Where a group of this transport carries tensors between ranks: gloo
    carries host tensors point to point, NCCL the rank's card, and torch's
    fake process group (``launch.dryrun``) carries nothing, so the carrier
    is the rank's own device. A rule on the transport, never a choice made
    by a failed call."""
    if transport == "gloo":
        return torch.device("cpu")
    if transport in ("nccl", "fake"):
        return device
    raise ValueError(f"no carrier rule for the {transport!r} transport")


@dataclasses.dataclass(eq=False)
class ProcessMesh:
    """This rank's view of a mesh of processes: the axis names and sizes,
    its rank in the world, the device its tensors live on, the process
    group of each axis it belongs to (rank order along an axis is the
    coordinate, so a model-axis group is in router order), the transport
    and the carrier device exchanges travel on. ``to_carrier`` and
    ``from_carrier`` move a tensor between the two and count each copy
    and its bytes; with the carrier the device itself they copy nothing."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    rank: int = 0
    device: torch.device = torch.device("cpu")
    groups: dict = dataclasses.field(default_factory=dict)
    transport: str = "gloo"
    carrier: torch.device = torch.device("cpu")
    carrier_copies: int = 0
    carrier_bytes: int = 0

    @property
    def sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def coords(self) -> dict[str, int]:
        """This rank's coordinate on each axis (row-major, last axis fastest)."""
        out, r = {}, self.rank
        for name, size in reversed(list(zip(self.axis_names, self.shape))):
            out[name] = r % size
            r //= size
        return {name: out[name] for name in self.axis_names}

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        if axis not in self.groups:
            raise ValueError(f"the mesh has no process group for axis {axis!r}; "
                             "build it with make_mesh")
        return self.groups[axis]

    def _move(self, t: torch.Tensor, device: torch.device) -> torch.Tensor:
        if t.device == device:
            return t
        self.carrier_copies += 1
        self.carrier_bytes += t.numel() * t.element_size()
        return t.to(device)

    def to_carrier(self, t: torch.Tensor) -> torch.Tensor:
        return self._move(t, self.carrier)

    def from_carrier(self, t: torch.Tensor) -> torch.Tensor:
        return self._move(t, self.device)


def make_mesh(shape, axes, *, device: str = "cuda") -> ProcessMesh:
    """Lay the world's ranks out as a ``shape`` mesh over ``axes`` and build
    every axis' process groups. Every rank of the world calls it (each
    group is made by all ranks, in one order) after
    ``init_process_group``; the world must have ``prod(shape)`` ranks. The
    groups take the world's transport: gloo where ranks share a card."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized() or dist.get_world_size() != math.prod(shape):
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise ValueError(f"a {shape} mesh needs a world of {math.prod(shape)} ranks, "
                         f"the world has {have}")
    rank = dist.get_rank()
    transport = str(dist.get_backend())
    dev = rank_device(rank, device)
    mesh = ProcessMesh(axes, shape, rank, dev, transport=transport,
                       carrier=carrier_device(transport, dev))
    grid = torch.arange(math.prod(shape)).reshape(shape)
    for i, axis in enumerate(axes):
        lines = grid.movedim(i, -1).reshape(-1, shape[i])
        for line in lines.tolist():
            g = dist.new_group(line)
            if rank in line:
                mesh.groups[axis] = g
        if dist.get_rank(mesh.groups[axis]) != mesh.coords[axis]:
            raise AssertionError(f"axis {axis}: group rank is not the mesh coordinate")
    return mesh


def production_layout(multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """(shape, axes) of a production mesh: (16, 16) over ("data", "model"),
    or (2, 16, 16) over ("pod", "data", "model")."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda") -> ProcessMesh:
    """The production meshes (``production_layout``): 256 ranks, or 512
    with the pod axis. Raises, naming the size it needs, in a world of any
    other size."""
    shape, axes = production_layout(multi_pod)
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise ValueError(f"the {'multi-pod' if multi_pod else 'single-pod'} production mesh "
                         f"{shape} needs {need} ranks; the world has {have}")
    return make_mesh(shape, axes, device=device)


def make_rules(*, multi_pod: bool = False, fsdp: bool = False) -> ShardRules:
    return ShardRules(
        tensor_axis="model",
        data_axis="data",
        pod_axis="pod" if multi_pod else None,
        fsdp=fsdp,
    )
