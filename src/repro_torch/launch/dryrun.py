"""Multi-pod dry run: one process stands in for one rank of a production
mesh, runs the port's own sharded step, prefill or decode on that rank's
shards, and counts what it costs while the code runs; one JSON a cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # every cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape prefill_32k --on-card                                   # needs a card

The port of ``repro.launch.dryrun``. The JAX package compiles each cell
for 512 fake host devices; here the world is torch's fake process group
(``dist.init_process_group("fake", ...)``: every collective returns at
once and writes nothing) of 256 or 512 ranks, and the rank's parameters,
optimizer state, batch and cache are tensors on the meta device (shapes
and dtypes, no storage), so no card and no host holds the mesh. The code
that runs is the port's: ``train.train_step.make_sharded_train_step``
with the reference's settings (remat on, the arch's microbatches), and
for prefill each parameter gathered to its compute spec as the sharded
step gathers it (``models.compute_specs``: the mixers (attention, Mamba,
mLSTM, sLSTM), the dense MLP, the embedding and the unembedding stay cut
on the model axis, the rank computing its heads, its channels and its
vocabulary slice), then ``models.forward_train`` (last-token logits of
the rank's vocabulary slice, K4 on); for decode the parameters gathered
to the same compute specs, then the tensor-parallel
``models.decode_step`` at ``pos = seq_len - 1`` on the rank's shard of
every cache leaf, never gathered: each attention cache its rows and its
block of the sequence (split-KV attention joined by log-sum-exp), each
Mamba, mLSTM or sLSTM state its rows and its block of the inner or
feature dim. ``--seq-parallel`` cuts the residual stream along the
sequence between blocks in the train and prefill cells; the decode does
not read it.

Counts, all taken while the one trace runs (``Counters``), exact, where
the reference extrapolates from depth-1 and depth-2 compiles because XLA
counts a loop body once:

* ``argument_bytes``: the rank's parameters, optimizer state, batch and
  cache; the rank traced is the one that holds the most (a
  ``dist.sharding.Holder`` makes ranks differ), ties to the lowest;
* the peak of live storage bytes on the rank's device over the trace,
  from its arguments on, each storage (views share it) counted once;
* FLOPs from ``torch.utils.flop_counter.FlopCounterMode``, K4 by its flop
  formula (``kernels.flash_attention.flash_attention_flops``);
* bytes accessed: each op's tensor inputs plus outputs (views and bare
  allocations move nothing), attention at K4's boundary where K4 runs;
* collective payload bytes and counts by kind, from the ``c10d`` ops:
  the tensors each one writes (for a send, sends).

``roofline_terms`` turns them into bounds with the H100's constants
(``PEAK_FLOPS``, ``HBM_BW``, ``LINK_BW``), and the JSON records whether
the peak fits the card's 80 GiB: bounds computed from counts, not times.
``--on-card`` runs the same rank's share on the card under the same fake
world (the collectives' outputs unwritten, so values are not checked) and
records its peak (``torch.cuda.max_memory_allocated``), its FLOPs and its
ms beside the meta trace's; it raises where there is no card.

``moe_collectives="auto"`` is decided by the analytic tuner, never
measured on the fake group. Output goes to ``experiments/dryrun_torch/``
(or ``--out``); a cell whose result exists is read back unless
``--force``. A failure is the port's own error: ``FAILED`` with it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import sys
import time
import weakref
from typing import Callable

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, SHAPES, cell_supported, get_config, input_specs
from repro_torch.dist import sharding as SH
from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.launch.mesh import make_mesh, make_rules, production_layout
from repro_torch.models import model as M
from repro_torch.models.moe import EXPERT_FF_DIM
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

# H100 SXM data sheet (the card: H100 80GB HBM3 at 700 W): roofline denominators
PEAK_FLOPS = 989e12       # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12          # B/s of HBM3
LINK_BW = 450e9           # B/s of NVLink, each way
HBM_BYTES = 80 * 2**30    # the card's memory

# per-arch microbatch counts for train_4k (activation-memory control)
MICROBATCHES = {
    "llama3-405b": 16,
    "deepseek-v3-671b": 16,
    "jamba-1.5-large-398b": 8,
    "mixtral-8x7b": 4,
    "qwen2-vl-7b": 4,
    "phi3-mini-3.8b": 2,
    "musicgen-large": 2,
    "tinyllama-1.1b": 1,
    "olmo-1b": 1,
    "xlstm-1.3b": 2,
}
FACTORED_OPT = {"llama3-405b", "deepseek-v3-671b", "jamba-1.5-large-398b"}

#: c10d op -> collective kind (the reference's HLO names), for the ops the
#: port issues; any other counts under its own name
C10D_KINDS = {"allgather_": "all-gather", "allreduce_": "all-reduce",
              "alltoall_base_": "all-to-all", "broadcast_": "broadcast", "reduce_": "reduce",
              "send": "send", "recv_": "recv"}
#: ops that allocate and move nothing
ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


# ----------------------------------------------------------------- counters
def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class Counters(TorchDispatchMode):
    """Counts, while it is on, every op that reaches the dispatcher: live
    storage bytes on ``device`` and their peak (a storage is counted when
    an op first returns it and until it is freed; ``hold`` counts tensors
    made before), bytes accessed and the c10d collectives' payload bytes
    and counts by kind. Use it beside ``FlopCounterMode``."""

    def __init__(self, device):
        super().__init__()
        self.device_type = torch.device(device).type
        self.live = 0
        self.peak = 0
        self.bytes_accessed = 0
        self.collective = {}
        self.collective_count = {}
        self._seen: dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        if t.device.type != self.device_type:
            return
        s = t.untyped_storage()
        key = s._cdata
        if key in self._seen:
            return
        self._seen[key] = s.nbytes()
        self.live += s.nbytes()
        weakref.finalize(s, self._free, key)
        self.peak = max(self.peak, self.live)

    def hold(self, tree) -> int:
        """Count the storages of ``tree``'s tensors as live from here on:
        the arguments, made before the trace. Returns the bytes added."""
        before = self.live
        for t in _tensors(tree):
            self._track(t)
        return self.live - before

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.namespace == "c10d":
            kind = C10D_KINDS.get(name, name)
            payload = sum(_nbytes(t) for t in _tensors(args[0] if args else ()))
            self.collective[kind] = self.collective.get(kind, 0) + payload
            self.collective_count[kind] = self.collective_count.get(kind, 0) + 1
            return out
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        if not func.is_view and name not in ALLOCATIONS:
            self.bytes_accessed += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes_accessed += sum(_nbytes(t) for t in outs)
        return out

    def collective_bytes(self) -> dict:
        """{kind: payload bytes, "_counts": {kind: ops}}, as the reference's
        ``collective_bytes`` reports them."""
        out = {k: float(v) for k, v in sorted(self.collective.items())}
        out["_counts"] = dict(sorted(self.collective_count.items()))
        return out


@contextlib.contextmanager
def counting(device):
    """(Counters, FlopCounterMode), both on for the block."""
    flops = FlopCounterMode(display=False)
    counters = Counters(device)
    with flops, counters:
        yield counters, flops


# ------------------------------------------------------------ the fake world
@contextlib.contextmanager
def fake_world(rank: int, world_size: int):
    """This process as rank ``rank`` of a fake process group of
    ``world_size`` ranks (torch's ``fake`` backend: collectives return at
    once and write nothing), torn down with the active rules after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake world: a process group exists")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
    try:
        yield
    finally:
        SH.clear_active()
        dist.destroy_process_group()


@contextlib.contextmanager
def analytic_tuner():
    """The process-wide autotuner in analytic mode for the block: ``auto``
    never measures on the fake group."""
    from repro_torch.runtime import autotune

    old = autotune._DEFAULT
    autotune.set_autotuner(autotune.Autotuner(mode="analytic", device="cpu"))
    try:
        yield
    finally:
        autotune.set_autotuner(old)


# ------------------------------------------------------------------- traces
@dataclasses.dataclass
class Trace:
    """What one rank of a cell runs: ``leaves``, every argument leaf as
    (name, spec, whole meta tensor); ``make(mesh)``, the rank's arguments
    on ``mesh.device``; ``run(args)``, the step."""

    leaves: list
    make: Callable
    run: Callable


def _spec_leaves(prefix: str, specs, like) -> list:
    return [(f"{prefix}/" + "/".join(map(str, path)), O.get(specs, path), t)
            for path, t in O.flatten(like)]


def _zeros_held(like, spec, mesh):
    """The rank's piece of a leaf under ``spec`` as zeros on the mesh's
    device (tokens of 0 are valid on the card), or None."""
    sl = SH.held_slices(spec, like.shape, mesh.coords, mesh.sizes)
    if sl is None:
        return None
    return torch.zeros(like[sl].shape, dtype=like.dtype, device=mesh.device)


def _zeros_tree(specs, like, mesh):
    return O.unflatten(like, [_zeros_held(t, O.get(specs, path), mesh)
                              for path, t in O.flatten(like)])


def trace_train(cfg, shape, rules, microbatches: int) -> Trace:
    """The sharded train step (``make_sharded_train_step``) with the
    reference's settings: remat on, ``microbatches``, the plain attention
    (K4 has no backward), the factored optimizer for ``FACTORED_OPT``."""
    opt_cfg = O.OptConfig(factored=cfg.name in FACTORED_OPT)
    settings = TS.TrainSettings(microbatches=microbatches, remat=True)
    pspecs, ospecs, bspecs, _ = TS.train_shardings(cfg, rules, opt_cfg, settings)
    like_p, like_s = TS.state_shapes(cfg, opt_cfg)
    batch = input_specs(cfg, shape)
    leaves = (_spec_leaves("params", pspecs, like_p) + _spec_leaves("opt", ospecs, like_s)
              + _spec_leaves("batch", bspecs, batch))

    def make(mesh):
        params, state = TS.shard_train_state(like_p, like_s, (pspecs, ospecs), mesh)
        return params, state, _zeros_tree(bspecs, batch, mesh)

    step = TS.make_sharded_train_step(cfg, opt_cfg, settings)
    return Trace(leaves, make, lambda args: step(*args))


def _experts_cut(cfg, rules, tokens: int) -> bool:
    """Whether ``moe_apply_auto`` takes a path that reads the expert stacks
    cut (EP or TP) for a rank's ``tokens``; else the sparse path reads
    them whole."""
    return not rules.expert_parallel(cfg.moe.num_experts) or tokens % rules.model_axis_size == 0


def _gathered(cfg, params, pspecs, like, rules, mesh, cut: bool):
    """Each parameter gathered to the spec it is computed under, as the
    sharded step gathers it (``models.compute_specs``: the tensor-parallel
    leaves and the MoE expert stacks kept cut on the model axis, the rest
    whole). Where ``cut`` is False (the sparse MoE path) the expert stacks
    are whole."""
    cspecs = M.compute_specs(cfg, rules)
    out = []
    for path, x in O.flatten(like):
        spec = O.get(pspecs, path)
        k = O.get(cspecs, path)
        if not cut and path[-1] in EXPERT_FF_DIM and "router" in O.get(like, path[:-1]):
            k = tuple(None for _ in k)
        out.append(TS._regather(O.get(params, path), spec, k, x, mesh))
    return O.unflatten(like, out)


def _rows(batch) -> int:
    """The batch rows a rank holds."""
    return next(batch[k].shape[0] for k in ("tokens", "embeds", "token", "embed") if k in batch)


def _batch_specs(batch, batch_ax) -> dict:
    out = {}
    for k, x in batch.items():
        if k == "mrope_positions":
            out[k] = (None, batch_ax, None)
        else:
            out[k] = (batch_ax,) + (None,) * (x.dim() - 1)
    return out


def trace_prefill(cfg, shape, rules) -> Trace:
    """``forward_train`` (K4 on, no remat) on the rank's rows, its
    parameters gathered first; the last token's logits."""
    pspecs = M.param_specs(cfg, rules)
    like = TS.param_shapes(cfg)
    # the labels are no input of a prefill (the reference's jit drops them as unused)
    batch = {k: v for k, v in input_specs(cfg, shape).items() if k != "labels"}
    bspecs = _batch_specs(batch, rules.batch_axes)
    leaves = _spec_leaves("params", pspecs, like) + _spec_leaves("batch", bspecs, batch)

    def make(mesh):
        return _zeros_tree(pspecs, like, mesh), _zeros_tree(bspecs, batch, mesh)

    def run(args):
        params, b = args
        act_rules, mesh = SH.active()
        with torch.no_grad():
            cut = cfg.moe is None or _experts_cut(cfg, act_rules, _rows(b) * shape.seq_len)
            tree = _gathered(cfg, params, pspecs, like, act_rules, mesh, cut)
            logits, _, _ = M.forward_train(tree, b, cfg, use_kernel=True, remat=False)
            return logits[:, -1]

    return Trace(leaves, make, run)


def trace_decode(cfg, shape, rules) -> Trace:
    """The tensor-parallel ``decode_step`` at ``pos = seq_len - 1`` on the
    rank's rows: the parameters gathered to their compute specs, each
    cache leaf (attention cache or recurrent state) the rank's shard as
    held, never gathered. A batch that the data axis (16) does not divide
    is replicated, as in the reference."""
    pspecs = M.param_specs(cfg, rules)
    cspecs = M.cache_specs(cfg, rules, shape.seq_len >= 262144)
    batch_ax = rules.batch_axes
    if shape.global_batch % 16:
        def debatch(spec):
            return tuple(None if e == batch_ax else e for e in spec)

        cspecs = O.map_specs(cspecs, lambda path, spec: debatch(spec))
        batch_ax = None
    like = TS.param_shapes(cfg)
    cache = M.init_cache(cfg, shape.global_batch, shape.seq_len, torch.bfloat16, device="meta")
    batch = input_specs(cfg, shape)
    bspecs = _batch_specs(batch, batch_ax)
    leaves = (_spec_leaves("params", pspecs, like) + _spec_leaves("cache", cspecs, cache)
              + _spec_leaves("batch", bspecs, batch))

    def make(mesh):
        return (_zeros_tree(pspecs, like, mesh), _zeros_tree(cspecs, cache, mesh),
                _zeros_tree(bspecs, batch, mesh))

    def run(args):
        params, held, b = args
        act_rules, mesh = SH.active()
        with torch.no_grad():
            cut = cfg.moe is None or _experts_cut(cfg, act_rules, _rows(b))
            tree = _gathered(cfg, params, pspecs, like, act_rules, mesh, cut)
            return M.decode_step(tree, held, b, shape.seq_len - 1, cfg)

    return Trace(leaves, make, run)


def trace_cell(cfg, shape, rules, microbatches: int = 1) -> Trace:
    if shape.kind == "train":
        return trace_train(cfg, shape, rules, microbatches)
    if shape.kind == "prefill":
        return trace_prefill(cfg, shape, rules)
    return trace_decode(cfg, shape, rules)


# --------------------------------------------------------- the traced rank
def rank_argument_bytes(leaves, axes, mesh_shape) -> list[int]:
    """Every rank's argument bytes (rank order: row-major over ``axes``).
    Splits are even, so a leaf's held bytes are the same on every rank
    that holds it; a ``Holder`` decides which ranks do. Raises, naming the
    leaf, where a spec asks for a split the mesh cannot make."""
    sizes = dict(zip(axes, mesh_shape))
    n = math.prod(mesh_shape)
    coords0 = {a: 0 for a in axes}
    common, by_holder = 0, {}
    for name, spec, t in leaves:
        try:
            holder, own = SH.split_holder(spec)
            sl = SH.local_slices(own, t.shape, coords0, sizes)
            nbytes = t[sl].numel() * t.element_size()
            key = None if holder is None else (SH.spec_axes(holder), holder.index(sizes))
        except ValueError as e:
            raise ValueError(f"{name} {tuple(t.shape)} under {spec}: {e}") from None
        if key is None:
            common += nbytes
        else:
            by_holder[key] = by_holder.get(key, 0) + nbytes
    out = []
    for r in range(n):
        coords, rest = {}, r
        for a, size in reversed(list(zip(axes, mesh_shape))):
            coords[a] = rest % size
            rest //= size
        total = common
        for (h_axes, index), nbytes in by_holder.items():
            at = 0
            for a in h_axes:
                at = at * sizes[a] + coords[a]
            total += nbytes if at == index else 0
        out.append(total)
    return out


def heaviest_rank(per_rank: list[int]) -> int:
    """The rank holding the most argument bytes; ties go to the lowest."""
    return max(range(len(per_rank)), key=lambda r: (per_rank[r], -r))


def run_trace(trace: Trace, rules, mesh_shape, axes, rank: int, device="meta",
              time_it: int = 0) -> dict:
    """Run ``trace`` as rank ``rank`` of a fake world of ``mesh_shape``
    ranks on ``device``, under the counters. With ``time_it`` > 0 (on the
    card) also time that many more runs, without counters (CUDA events,
    after the counted run as a warm-up), and read the card's peak."""
    n = math.prod(mesh_shape)
    dev = torch.device(device)
    with fake_world(rank, n), analytic_tuner():
        mesh = make_mesh(mesh_shape, axes, device=device)
        SH.set_active(rules, mesh)
        args = trace.make(mesh)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            start_card = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        k4, k4_bodies = flash_attention.launches, dict(flash_attention.body_launches)
        t0 = time.perf_counter()
        with counting(dev) as (counters, flops):
            held = counters.hold(args)
            out = trace.run(args)
            del out
        seconds = time.perf_counter() - t0
        res = {"argument_bytes_held": held, "peak_bytes": counters.peak,
               "flops": float(flops.get_total_flops()),
               "bytes_accessed": float(counters.bytes_accessed),
               "collectives": counters.collective_bytes(), "trace_seconds": seconds,
               "carrier_copies": mesh.carrier_copies, "k4_launches": flash_attention.launches - k4,
               "k4_bodies": {body: n - k4_bodies[body]
                             for body, n in flash_attention.body_launches.items()}}
        if dev.type == "cuda":
            torch.cuda.synchronize()
            res["card_start_bytes"] = start_card
            res["card_peak_bytes"] = torch.cuda.max_memory_allocated()
            ms = []
            for _ in range(time_it):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                out = trace.run(args)
                b.record()
                b.synchronize()
                ms.append(a.elapsed_time(b))
                del out
            res["ms"] = ms
        del args
    return res


# ----------------------------------------------------------------- analyze
def roofline_terms(result: dict, cfg, shape) -> dict:
    """Three-term roofline of the traced rank's counts on the H100: compute
    (FLOPs at the bf16 peak), memory (bytes accessed at HBM's rate) and
    collective (payload bytes at NVLink's rate each way; a send's bytes
    are its receive's). Bounds, not times."""
    n = result["n_chips"]
    cost = result["cost"]
    compute_s = cost["flops"] / PEAK_FLOPS
    memory_s = cost["bytes"] / HBM_BW
    # a point-to-point transfer once, where it arrives (its send is the same bytes)
    cbytes = sum(v for k, v in result["collectives"].items() if k not in ("_counts", "send"))
    collective_s = cbytes / LINK_BW
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6 if shape.kind == "train" else 2
    model_flops = mult * cfg.active_param_count() * tokens
    dominant = max(("compute", compute_s), ("memory", memory_s), ("collective", collective_s),
                   key=lambda kv: kv[1])[0]
    bound = max(compute_s, memory_s, collective_s)
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "model_flops": model_flops,
        "useful_flops_ratio": model_flops / max(cost["flops"] * n, 1.0),
        "step_time_bound_s": bound,
        "roofline_fraction": compute_s / bound if bound > 0 else 0.0,
    }


def analyze(cfg, shape, rules, mesh_shape, axes, microbatches: int = 1, *, device="meta",
            time_it: int = 0) -> dict:
    """Trace one cell on the rank that holds the most argument bytes: the
    counts of ``run_trace`` with ``argument_bytes`` and the rank."""
    trace = trace_cell(cfg, shape, rules, microbatches)
    per_rank = rank_argument_bytes(trace.leaves, axes, mesh_shape)
    rank = heaviest_rank(per_rank)
    res = run_trace(trace, rules, mesh_shape, axes, rank, device=device, time_it=time_it)
    if res["argument_bytes_held"] != per_rank[rank]:
        raise AssertionError(f"rank {rank} holds {res['argument_bytes_held']} argument bytes, "
                             f"its specs give {per_rank[rank]}")
    res["rank"] = rank
    res["argument_bytes"] = per_rank[rank]
    res["argument_bytes_min"] = min(per_rank)
    return res


def analyze_cell(arch: str, shape_name: str, multi_pod: bool, force=False,
                 variant: dict | None = None, tag: str = "", out_dir=None,
                 on_card: bool = False) -> dict:
    """One cell (``arch`` × ``shape_name`` × mesh) traced and saved, as the
    reference's ``analyze_cell``; ``on_card`` also runs the traced rank's
    share on the card, and raises where there is none."""
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("--on-card runs the rank's share on a CUDA card and found none")
    shape = SHAPES[shape_name]
    mesh_tag = "pod2" if multi_pod else "pod1"
    suffix = f"__{tag}" if tag else ""
    out_dir = pathlib.Path(out_dir) if out_dir else RESULTS_DIR
    name = f"{arch}__{shape_name}__{mesh_tag}{suffix}{'__on_card' if on_card else ''}.json"
    out_path = out_dir / name
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    ok, reason = cell_supported(arch, shape_name)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_tag, "time": time.time()}
    if not ok:
        result["status"] = "skipped"
        result["reason"] = reason
        _save(out_path, result)
        return result

    cfg = get_config(arch)
    mesh_shape, axes = production_layout(multi_pod)
    rules = make_rules(multi_pod=multi_pod)
    variant = dict(variant or {})
    mb_override = variant.pop("microbatches", None)
    if variant:
        rules = dataclasses.replace(rules, **variant)
    if variant or mb_override:
        result["variant"] = dict(variant, microbatches=mb_override)

    # what the price-driven autotuner would pick for this cell's MoE
    # dispatch site (analytic: deterministic, nothing measured or written)
    from repro_torch.runtime import autotune
    result["autotune"] = autotune.moe_site_report(
        cfg, rules, n_tokens=shape.global_batch * shape.seq_len,
        tuner=autotune.Autotuner(mode="analytic", device="cpu"))
    mb = MICROBATCHES.get(arch, 1) if shape.kind == "train" else 1
    if mb_override:
        mb = mb_override
    rules = dataclasses.replace(rules, data_axis_size=mesh_shape[-2],
                                model_axis_size=mesh_shape[-1])

    t0 = time.time()
    try:
        res = analyze(cfg, shape, rules, mesh_shape, axes, mb)
        card = None
        if on_card:
            card = run_trace(trace_cell(cfg, shape, rules, mb), rules, mesh_shape, axes,
                             res["rank"], device="cuda", time_it=3)
    except Exception as e:  # a dry-run failure is a fault of the port, or of the cell
        result["status"] = "FAILED"
        result["error"] = f"{type(e).__name__}: {e}"[:2000]
        result["trace_seconds"] = round(time.time() - t0, 1)
        _save(out_path, result)
        return result

    result.update({
        "status": "ok",
        "trace_seconds": round(time.time() - t0, 1),
        "n_chips": math.prod(mesh_shape),
        "rank": res["rank"],
        "microbatches": mb,
        "memory": {
            "argument_bytes": res["argument_bytes"],
            "argument_bytes_least_rank": res["argument_bytes_min"],
            "peak_bytes": res["peak_bytes"],
            "fits_80gib": res["peak_bytes"] <= HBM_BYTES,
        },
        "cost": {"flops": res["flops"], "bytes": res["bytes_accessed"]},
        "collectives": res["collectives"],
        "carrier_copies": res["carrier_copies"],
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
    })
    result["roofline"] = roofline_terms(result, cfg, shape)
    if card is not None:
        result["on_card"] = {
            "device": torch.cuda.get_device_name(0),
            "start_bytes": card["card_start_bytes"],
            "max_memory_allocated": card["card_peak_bytes"],
            "meta_peak_bytes": res["peak_bytes"],
            "peak_rel_diff": abs(res["peak_bytes"] - card["card_peak_bytes"])
            / card["card_peak_bytes"],
            "flops": card["flops"],
            "flops_equal": card["flops"] == res["flops"],
            "k4_launches": card["k4_launches"],
            "k4_bodies": card["k4_bodies"],
            "ms": card["ms"],
        }
    _save(out_path, result)
    return result


def _save(path: pathlib.Path, result: dict):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(result, indent=1, default=str))


# --------------------------------------------------------------------- CLI
def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--moe-collectives",
                    choices=["xla", "dragonfly", "dragonfly_overlap",
                             "dragonfly_overlap_fused", "auto"],
                    default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None, help="the results' directory "
                    "(default experiments/dryrun_torch/)")
    ap.add_argument("--on-card", action="store_true",
                    help="also run the traced rank's share on the card (needs one)")
    args = ap.parse_args(argv)

    variant = {}
    if args.fsdp:
        variant["fsdp"] = True
    if args.zero1:
        variant["zero1"] = True
    if args.seq_parallel:
        variant["seq_parallel"] = True
    if args.moe_collectives:
        variant["moe_collectives"] = args.moe_collectives
    if args.microbatches:
        variant["microbatches"] = args.microbatches
    if variant and not args.tag:
        ap.error("--tag required when variant knobs are set")

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    failures = 0
    for a, s, mp in cells:
        t0 = time.time()
        r = analyze_cell(a, s, mp, force=args.force, variant=variant or None, tag=args.tag,
                         out_dir=args.out, on_card=args.on_card)
        tag = "pod2" if mp else "pod1"
        status = r["status"]
        extra = ""
        if status == "ok":
            rf = r["roofline"]
            extra = (f"trace={r['trace_seconds']}s dominant={rf['dominant']}"
                     f" terms(c/m/k)={rf['compute_s']:.3e}/{rf['memory_s']:.3e}/"
                     f"{rf['collective_s']:.3e}s peak={r['memory']['peak_bytes'] / 2**30:.1f}GiB")
        elif status == "FAILED":
            failures += 1
            extra = r.get("error", "")[:160]
        else:
            extra = r.get("reason", "")
        print(f"{a:24s} {s:12s} {tag}  {status:8s} {extra}", flush=True)
        line = {"arch": a, "shape": s, "mesh": tag, "status": status,
                "seconds": round(time.time() - t0, 2)}
        for key in ("rank", "memory", "cost", "collectives", "roofline", "on_card", "error"):
            if key in r:
                line[key] = r[key]
        print("dryrun: " + json.dumps(line), flush=True)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
