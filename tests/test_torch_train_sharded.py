"""The sharded training step (``train.train_step.make_sharded_train_step``)
on 8 gloo ranks, against the JAX package's sharded ``jax.jit`` of
``make_train_step`` and against the port's one-process step.

Eight gloo ranks on the CPU (spawned once for the module through
``repro_torch.launch.mesh.spawn``) lay themselves out as (data, model)
meshes, register the case's rules with ``dist.sharding.set_active``, cut
the JAX package's initial parameters (carried across by
``models.convert.params_from_jax``) and zero optimizer state to their
shards with ``shard_train_state``, take their rows with ``shard_batch``,
run two steps and put the state back whole with ``gather_train_state``.
The JAX side runs this file as a script on 8 forced host devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/test_torch_train_sharded.py OUT.npz PARAMS.npz CASE...

which runs ``jax.jit(make_train_step(...), in_shardings=train_shardings
(...), out_shardings=...)`` under ``set_active(rules, mesh)``, as
``repro.launch.dryrun.lower_train`` builds it. The module runs it three
times at once on ``JAX_PARTS``; the first writes the initial parameters
and the tokens first, which the ranks wait for.

Cases (``CASES``): TinyLlama smoke at (2, 4) with FSDP, with ZeRO-1 and
with neither, and at (4, 2) with two microbatches, of 4 rows and of 2
(each row then on two data coordinates); Mixtral smoke at (2, 4)
under EP (FSDP, so each data coordinate holds one whole layer, experts
included) in ``xla``, ``dragonfly`` and ``dragonfly_overlap``, and at
(1, 8) under TP (4 experts do not split over 8); the same EP case in
``dragonfly_overlap_fused`` (its round trip differentiated wave by wave)
and in ``auto`` with the ranks' tuner forced to that mode; DeepSeek smoke at (2, 4)
(MLA, the shared expert, the dense prefix, the MTP block); Jamba smoke at
(2, 4) (Mamba's ``_SelectiveScan`` under the step, on the rank's
channels); the factored
optimizer on TinyLlama smoke widened to d 128 and d_ff 256, so that
``_factorable`` holds on leaves whose last or second-to-last dim is
sharded (``wq``, the MLP, the embedding); and ``compress_grads`` on
TinyLlama smoke with FSDP and with ZeRO-1 (``err`` cut as the parameters,
the moments over the data axes too) and on Mixtral smoke's EP case
(``COMPRESS``), held to the port's one-process compressed step alone: the
reference's compressed step raises on every model (its
``decompress_tree`` flattens the codes' tuples as leaves); and
``seq_parallel`` on TinyLlama smoke with FSDP, Mixtral smoke's ``xla`` EP
case and DeepSeek smoke (the residual stream cut along the sequence
between blocks), held to the reference's jit with ``seq_parallel=True``.
Every case computes the mixers (attention, Mamba), the dense MLP, the
shared expert, the embedding and the unembedding tensor-parallel on the
model axis (``models.compute_specs``). The JAX side runs the EP cases'
``xla`` mode and its fused mode: its three exchange-only modes are
bit-identical (``tests/test_torch_moe_ep.py``), and ``auto`` forced to the
fused mode runs the fused mode.

Tolerances: every leaf of the gathered parameters and optimizer state
within ``MODEL_TOL`` (1e-4, ||Δ|| relative to the leaf's norm) of the
reference's after two steps, ``loss`` and ``grad_norm`` within
``LOSS_TOL`` (1e-5 relative) at each step; the same against the port's
one-process step (whose MoE layers are ``moe_apply_ep_plain`` or
``moe_apply_tp_plain`` at the case's mesh), where the routes and drops of
step 1 are exact. The ranks also hold the differentiable collectives'
adjoints (float64, ``ADJOINT_TOL``), the fused round trip's among them,
what that round trip saves for its backward, its layer's gradients
against ``dragonfly``'s, four planted faults that must fail the
comparison (one quantizes each rank's shard on its own), two on the
tensor axis that must fail it and the comparison with the reference's
jit (a row block's output, and under ``seq_parallel`` the sequence
gather, each with a backward that does not sum), a planted
truncating cast of the codes that only the cap on differing codes
(``FLIP_SHARE``) rejects at the codes, the mesh's
compression of planted gradients against ``compression.compress_tree``
bit for bit, and the dry run's decode cell, which ``seq_parallel`` leaves
as it was.

The whole compressed step cannot give the one-process codes bit for bit:
its gradient sums add in another order, so a value at a half-step of its
block's scale may round the other way; such codes are capped at
``FLIP_SHARE`` of the values.
"""

import contextlib
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import get_smoke_config
from repro_torch.dist import collectives as CL
from repro_torch.dist import sharding as SH
from repro_torch.dist.mesh import dragonfly_layout
from repro_torch.launch import mesh as LM
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime.backends.torch_dist import TorchDistBackend
from repro_torch.train import compression as C
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS
from test_torch_moe_ep import SEP, flatten as flat_tree, unflatten as unflat, wait_for

TESTS = pathlib.Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
MODEL_TOL = 1e-4
LOSS_TOL = 1e-5
ADJOINT_TOL = 1e-12
#: the largest share of a compressed case's values whose int8 code may
#: differ from the one-process step's, each by one: a value at a half-step
#: of its block's scale, which the sharded sum's other order rounds the
#: other way
FLIP_SHARE = 1e-4
SEQ = 32
STEPS = 2
#: name -> (arch, mesh (data, model), ShardRules changes, microbatches,
#: batch rows, factored optimizer)
CASES = {
    "tiny_fsdp": ("tinyllama-1.1b", (2, 4), {"fsdp": True}, 1, 4, False),
    "tiny_zero1": ("tinyllama-1.1b", (2, 4), {"zero1": True}, 1, 4, False),
    "tiny_plain": ("tinyllama-1.1b", (2, 4), {}, 1, 4, False),
    "tiny_mb": ("tinyllama-1.1b", (4, 2), {}, 2, 8, False),
    "tiny_mb_rows": ("tinyllama-1.1b", (4, 2), {}, 2, 4, False),  # 2 rows a microbatch, 4 shards
    "mix_xla": ("mixtral-8x7b", (2, 4), {"fsdp": True, "moe_collectives": "xla"}, 1, 4, False),
    "mix_dragonfly": ("mixtral-8x7b", (2, 4), {"fsdp": True, "moe_collectives": "dragonfly"},
                      1, 4, False),
    "mix_overlap": ("mixtral-8x7b", (2, 4),
                    {"fsdp": True, "moe_collectives": "dragonfly_overlap"}, 1, 4, False),
    "mix_fused": ("mixtral-8x7b", (2, 4),
                  {"fsdp": True, "moe_collectives": "dragonfly_overlap_fused"}, 1, 4, False),
    "mix_auto": ("mixtral-8x7b", (2, 4), {"fsdp": True, "moe_collectives": "auto"}, 1, 4, False),
    "mix_tp": ("mixtral-8x7b", (1, 8), {}, 1, 4, False),
    "deepseek": ("deepseek-v3-671b", (2, 4), {"fsdp": True}, 1, 4, False),
    "jamba": ("jamba-1.5-large-398b", (2, 4), {"fsdp": True}, 1, 4, False),
    "factored": ("tinyllama-1.1b", (2, 4), {"fsdp": True}, 1, 4, True),
    "tiny_fsdp_compress": ("tinyllama-1.1b", (2, 4), {"fsdp": True}, 1, 4, False),
    "tiny_zero1_compress": ("tinyllama-1.1b", (2, 4), {"zero1": True}, 1, 4, False),
    "mix_compress": ("mixtral-8x7b", (2, 4), {"fsdp": True, "moe_collectives": "xla"}, 1, 4,
                     False),
    "tiny_fsdp_sp": ("tinyllama-1.1b", (2, 4), {"fsdp": True, "seq_parallel": True}, 1, 4,
                     False),
    "mix_xla_sp": ("mixtral-8x7b", (2, 4),
                   {"fsdp": True, "moe_collectives": "xla", "seq_parallel": True}, 1, 4, False),
    "deepseek_sp": ("deepseek-v3-671b", (2, 4), {"fsdp": True, "seq_parallel": True}, 1, 4,
                    False),
}
#: the cases that train with ``compress_grads``: the reference's compressed
#: step raises on every model, so the port's one-process step is their oracle
COMPRESS = ("tiny_fsdp_compress", "tiny_zero1_compress", "mix_compress")
#: the cases held to the reference's jit
REF_CASES = [name for name in CASES if name not in COMPRESS]
#: the EP cases whose reference is another case's: the exchange-only modes
#: the ``xla`` mode's, ``auto`` (forced to the fused mode: ``AUTO_FORCE``)
#: the fused mode's
SAME_AS = {"mix_dragonfly": "mix_xla", "mix_overlap": "mix_xla", "mix_auto": "mix_fused"}
#: the strategy the ranks' autotuner is forced to in the ``auto`` case
AUTO_FORCE = "overlap_fused"
#: the JAX side's three subprocesses: (writes the weights, the cases it runs)
JAX_PARTS = ((True, ("jamba", "tiny_mb", "mix_fused", "tiny_mb_rows")),
             (False, ("deepseek", "mix_xla", "mix_tp", "deepseek_sp")),
             (False, ("tiny_fsdp", "tiny_zero1", "tiny_plain", "factored", "tiny_fsdp_sp",
                      "mix_xla_sp")))
WIDE = {"d_model": 128, "d_ff": 256}  # the factored case's widths


def case_cfg(cfg, name):
    """The case's config, the same change on both sides."""
    return dataclasses.replace(cfg, **WIDE) if CASES[name][5] else cfg


#: the optimizer of ``tests/test_torch_train_loop.py``. At step 1 Adam moves
#: every parameter by about lr·sign(g), so a gradient of ~1e-10 whose sign
#: differs by rounding moves it by 2·lr: the parameters' distance after a
#: step grows with lr, while the moments do not move with it.
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)


def opt_cfg(OptConfig, name):
    return OptConfig(factored=CASES[name][5], **OPT)


def settings_of(name):
    return TS.TrainSettings(microbatches=CASES[name][3], compress_grads=name in COMPRESS)


def init_state(params, oc, name):
    """Zero optimizer state, with the error-feedback state where the case compresses."""
    s = O.init_state(params, oc)
    return dict(s, err=C.init_error(params)) if name in COMPRESS else s


def tokens(name, vocab):
    rows = CASES[name][4]
    return np.random.default_rng(7).integers(1, vocab, (rows, SEQ)).astype(np.int32)


def n_moe(cfg) -> int:
    """MoE layers of a forward: the first this many routes a recording
    holds are the forward's (remat's recompute records them again)."""
    return sum(1 for _, ffn in TT.layer_kinds(cfg) if ffn == "moe")


# ------------------------------------------------- the port's side: a rank
def _setup(name, flat):
    arch, shape, kw, _, _, _ = CASES[name]
    cfg = case_cfg(get_smoke_config(arch), name)
    mesh = LM.make_mesh(shape, ("data", "model"), device="cpu")
    SH.set_active(SH.ShardRules(**kw), mesh)
    rules = SH.active()[0]
    oc = opt_cfg(O.OptConfig, name)
    settings = settings_of(name)
    params = params_from_jax(unflat(flat, f"params{SEP}{name}"), cfg, device="cpu")
    specs = TS.train_shardings(cfg, rules, oc, settings)
    p, s = TS.shard_train_state(params, init_state(params, oc, name), specs[:2], mesh)
    t = torch.from_numpy(flat[f"tokens{SEP}{name}"]).long()
    batch = TS.shard_batch({"tokens": t, "labels": t}, specs[2], mesh)
    return cfg, mesh, oc, settings, specs, p, s, batch


def run_case(name, flat, rank, steps=STEPS):
    from repro_torch.runtime import autotune

    if CASES[name][2].get("moe_collectives") == "auto":
        autotune.set_autotuner(autotune.Autotuner(force=AUTO_FORCE, device="cpu"))
    try:
        return _run_case(name, flat, rank, steps)
    finally:
        autotune.set_autotuner(None)


@contextlib.contextmanager
def recording_codes(module, attr):
    """Record, as numpy, the codes of every call of ``module.attr`` (a
    compression that returns its codes, keyed by JAX path, first)."""
    real, calls = getattr(module, attr), []

    def record(*args):
        out = real(*args)
        calls.append({SEP.join(map(str, key)): (q.numpy().copy(), sc.numpy().copy())
                      for key, (q, sc) in out[0].items()})
        return out

    setattr(module, attr, record)
    try:
        yield calls
    finally:
        setattr(module, attr, real)


def _run_case(name, flat, rank, steps):
    cfg, mesh, oc, settings, specs, p, s, batch = _setup(name, flat)
    step = TS.make_sharded_train_step(cfg, oc, settings)
    metrics, routes = [], None
    with recording_codes(TS, "_compress") as codes:
        for i in range(steps):
            if i == 0 and cfg.moe is not None:
                with TMOE.recording_routes() as rec:
                    p, s, m = step(p, s, batch)
                routes = [(idx.numpy(), keep.numpy()) for idx, keep, _ in rec[:n_moe(cfg)]]
            else:
                p, s, m = step(p, s, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    gp, gs = TS.gather_train_state(p, s, specs[:2], TS.state_shapes(cfg, oc), mesh)
    out = {"metrics": metrics, "routes": routes, "coords": mesh.coords}
    if rank == 0:
        state = {}
        flat_tree(gp, "params", state)
        flat_tree(gs, "opt", state)
        out["state"] = state
        out["codes"] = codes
    SH.clear_active()
    return out


def adjoints(rank):
    """<A x, y> and <x, Aᵀ y> on this rank, float64, for every
    differentiable collective: A's forward, Aᵀ through autograd."""
    mesh = LM.make_mesh((2, 4), ("data", "model"), device="cpu")
    group = mesh.group("model")
    layout = dragonfly_layout(4)
    gen = torch.Generator().manual_seed(100 + rank)
    ops = {
        "native_all_to_all": lambda x: CL.native_all_to_all(x, group, mesh=mesh),
        "dragonfly_all_to_all": lambda x: CL.dragonfly_all_to_all(x, group, layout,
                                                                  mesh=mesh),
        "dragonfly_all_to_all_overlap": lambda x: CL.dragonfly_all_to_all(
            x, group, layout, backend=TorchDistBackend(overlap=True), mesh=mesh),
        "all_gather": lambda x: CL.all_gather(x, group, mesh=mesh),
        "all_reduce_sum": lambda x: CL.all_reduce_sum(x, torch.distributed.group.WORLD,
                                                      mesh=mesh),
    }
    out = {}
    for op, fn in ops.items():
        x = torch.randn((4, 3, 5), generator=gen, dtype=torch.float64).requires_grad_(True)
        ax = fn(x)
        y = torch.randn(ax.shape, generator=gen, dtype=torch.float64)
        (aty,) = torch.autograd.grad(ax, x, y)
        out[op] = (float((ax * y).sum()), float((x * aty).sum()))
    # the fused round trip with a chunk transform linear in x and in the
    # rank's weights w: <RT(x; w), y> = <x, d/dx> = <w, d/dw>
    x = torch.randn((4, 3, 5), generator=gen, dtype=torch.float64).requires_grad_(True)
    w = torch.randn((5, 5), generator=gen, dtype=torch.float64).requires_grad_(True)
    rt = CL.dragonfly_round_trip(x, [w], lambda ws, h: h @ ws[0], group, layout,
                                 TorchDistBackend(overlap_fused=True), mesh=mesh)
    y = torch.randn(rt.shape, generator=gen, dtype=torch.float64)
    gx, gw = torch.autograd.grad(rt, (x, w), y)
    out["dragonfly_round_trip"] = (float((rt * y).sum()), float((x * gx).sum()))
    out["dragonfly_round_trip_weights"] = (float((rt * y).sum()), float((w * gw).sum()))
    return out


def round_trip_saves(rank):
    """What the fused round trip saves for its backward, through the
    saved-tensor hooks that a non-reentrant checkpoint uses: the number of
    tensors packed against 1 weight plus the number of waves that ran
    ``fn``, with grad and under ``no_grad``; and whether the gradients
    under ``checkpoint`` (arrivals freed, then made again by the
    recompute) are the plain backward's bits."""
    mesh = LM.make_mesh((2, 4), ("data", "model"), device="cpu")
    group, layout = mesh.group("model"), dragonfly_layout(4)
    gen = torch.Generator().manual_seed(200 + rank)
    x = torch.randn((4, 3, 5), generator=gen, dtype=torch.float64).requires_grad_(True)
    w = torch.randn((5, 5), generator=gen, dtype=torch.float64).requires_grad_(True)
    y = torch.randn((4, 3, 5), generator=gen, dtype=torch.float64)
    waves = []

    def fn(ws, h):
        waves.append(h.shape[0])
        return torch.tanh(h @ ws[0])

    def rt(x, w):
        return CL.dragonfly_round_trip(x, [w], fn, group, layout,
                                       TorchDistBackend(overlap_fused=True), mesh=mesh)

    packed = []

    def pack(t):
        packed.append(tuple(t.shape))
        return t

    out = {}
    for grad in (True, False):
        packed.clear()
        waves.clear()
        with torch.set_grad_enabled(grad), \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            rt(x, w)
        out["with_grad" if grad else "no_grad"] = {"packed": len(packed),
                                                   "waves": len(waves)}
    plain = torch.autograd.grad((rt(x, w) * y).sum(), (x, w))
    remat = torch.autograd.grad((checkpoint(rt, x, w, use_reentrant=False) * y).sum(), (x, w))
    out["checkpoint_same_grads"] = all(torch.equal(a, b) for a, b in zip(plain, remat))
    return out


def fused_layer_grads(rank):
    """Mixtral smoke's MoE layer on (2, 4) in float64 under
    ``dragonfly`` and ``dragonfly_overlap_fused``: each gradient's
    ||Δ|| / ||dragonfly's|| (the input, the router, the three expert
    stacks) and whether the outputs agree bit for bit."""
    from repro_torch.models import model as M

    cfg = get_smoke_config("mixtral-8x7b")
    mesh = LM.make_mesh((2, 4), ("data", "model"), device="cpu")
    ffn = M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")["stack"][0]["ffn"]
    ffn = {k: v.double() for k, v in ffn.items()}
    gen = torch.Generator().manual_seed(1 + mesh.coords["data"])
    x0 = torch.randn((2, 16, cfg.d_model), generator=gen, dtype=torch.float64)
    probe = torch.randn((2, 16, cfg.d_model), generator=torch.Generator().manual_seed(5),
                        dtype=torch.float64)
    got = {}
    for mode in ("dragonfly", "dragonfly_overlap_fused"):
        SH.set_active(SH.ShardRules(moe_collectives=mode), mesh)
        leaves = {k: v.clone().requires_grad_(True) for k, v in ffn.items()}
        x = x0.clone().requires_grad_(True)
        y, aux = TMOE.moe_apply_ep(leaves, x, cfg)
        grads = torch.autograd.grad((y * probe).sum() + aux, [x, *leaves.values()])
        got[mode] = (y.detach(), dict(zip(["x", *leaves], grads)))
    SH.clear_active()
    (y_d, g_d), (y_f, g_f) = got["dragonfly"], got["dragonfly_overlap_fused"]
    return {"same_output": bool(torch.equal(y_d, y_f)),
            "rel": {k: float((g_f[k] - g).norm() / g.norm().clamp(min=1e-300))
                    for k, g in g_d.items()}}


def planted(name, flat, rank, fault):
    """One step of ``name`` with a planted fault; returns what
    ``run_case`` returns, or the error it raised."""
    saved = {}

    def patch(module, attr, value):
        saved[(module, attr)] = getattr(module, attr)
        setattr(module, attr, value)

    if fault == "seed_unscaled":  # summed over the model axis, the seed not scaled for it
        patch(TS, "_seed", lambda mesh: 1.0 / mesh.sizes["data"])
    elif fault == "gather_no_sum":  # the output gather's backward: the rank's slice alone
        def slice_only(g, group):
            n, r = torch.distributed.get_world_size(group), torch.distributed.get_rank(group)
            return g.chunk(n)[r].contiguous()

        patch(CL, "_gather_transpose", slice_only)
    elif fault == "row_sum_no_backward":  # a row block's output: each rank's own cotangent
        def row_sum(x, group, mesh=None):
            return CL._Collective.apply(x, lambda t: CL._f32_sum(t, group), lambda g: g, mesh)

        patch(CL, "tp_sum", row_sum)
    elif fault == "seq_gather_no_sum":  # its backward: the rank's block, not the sum's
        def gather_block(x, dim, group, mesh=None):
            n, r = torch.distributed.get_world_size(group), torch.distributed.get_rank(group)
            return CL._Collective.apply(x, lambda t: CL._gather_along(t, dim, group),
                                        lambda g: g.chunk(n, dim)[r].contiguous(), mesh)

        patch(CL, "seq_gather", gather_block)
    elif fault == "per_shard_compress":
        patch(TS, "_compress", per_shard_compress)
    elif fault == "truncated_codes":
        patch(C, "quantize", truncating_quantize)
    elif fault in ("no_backward", "none_as_zeros"):  # the exchanges invisible to autograd
        def no_backward(x, group=None, mesh=None):
            return CL._on_carrier(lambda t: CL._native_exchange(t, group), x.detach(), mesh)

        patch(CL, "native_all_to_all", no_backward)
        if fault == "none_as_zeros":
            patch(TS, "_missing_grad", lambda path, batch, leaf: torch.zeros(
                leaf.shape, dtype=torch.float32, device=leaf.device))
    try:
        return run_case(name, flat, rank, steps=STEPS if fault in TP_FAULTS else 1)
    except (RuntimeError, NotImplementedError) as e:
        SH.clear_active()
        return {"error": f"{type(e).__name__}: {e}"}
    finally:
        for (module, attr), value in saved.items():
            setattr(module, attr, value)


def planted_grads(cfg, seed=11):
    """(whole gradients, whole errors) of ``cfg``'s parameters in the port's
    layout, normals from a numpy seed (errors at a hundredth of the scale)."""
    rng = np.random.default_rng(seed)
    like = TS.param_shapes(cfg)
    grads = O.unflatten(like, [torch.from_numpy(rng.standard_normal(x.shape, np.float32))
                               .to(x.dtype) for _, x in O.flatten(like)])
    errs = O.unflatten(like, [torch.from_numpy(rng.standard_normal(x.shape, np.float32) / 100)
                              for _, x in O.flatten(like)])
    return grads, errs


def mesh_codes(name, flat, rank):
    """The mesh's compression (``train_step._compress``) of the planted
    whole gradients and errors under ``name``'s rules: each leaf's gradient
    held, cut by its compute spec, by the ranks at coordinate 0 of the axes
    it is summed over (the rest give zeros, so the sums are the planted
    values), its error cut to the rank's ``err`` shard. Returns the codes
    and the rank's pieces of the dequantized gradient and the new error."""
    cfg, mesh, oc, settings, specs, _, _, _ = _setup(name, flat)
    rules = SH.active()[0]
    pspecs, ospecs = specs[:2]
    grads, errs = planted_grads(cfg)
    like_p = TS.param_shapes(cfg)
    paths = [path for path, _ in O.flatten(like_p)]
    cspecs = TM.compute_specs(cfg, rules)
    keep = {path: O.get(cspecs, path) for path in paths}
    g_sum = []
    for path in paths:
        g = O.get(grads, path)
        g = g[SH.local_slices(keep[path], g.shape, mesh.coords, mesh.sizes)]
        g_sum.append(torch.zeros_like(g) if TS._replica(keep[path], mesh) else g.clone())
    err = O.unflatten(like_p, [TS._held(O.get(errs, path), O.get(ospecs["err"], path), mesh)
                               for path in paths])
    mspecs = {path: O.get(ospecs["mu"], path)["m"] for path in paths}
    codes, deq, new_err = TS._compress(g_sum, err, 1, paths, keep, pspecs, mspecs, like_p,
                                       len(cfg.layer_kinds()), mesh)
    SH.clear_active()
    return {"codes": {SEP.join(map(str, k)): (q.numpy(), sc.numpy())
                      for k, (q, sc) in codes.items()},
            "grads": {SEP.join(map(str, k)): None if v is None else v.numpy()
                      for k, v in deq.items()},
            "err": {SEP.join(map(str, k)): None if v is None else v.numpy()
                    for k, v in new_err.items()},
            "coords": mesh.coords}


def per_shard_compress(g_sum, err, mb_n, paths, keep, pspecs, mspecs, like_p, period, mesh):
    """A planted fault in ``train_step._compress``'s place: each rank
    quantizes the piece of each leaf that its optimizer state holds with
    its own error, blocks cut by the shard instead of the JAX leaf."""
    grads, new_err = {}, {}
    for i, path in enumerate(paths):
        assert mspecs[path] == O.get(pspecs, path), path  # FSDP: the state cut as the leaf
        g, g_sum[i] = g_sum[i], None
        g = TS._reduce_to(g / mb_n if mb_n > 1 else g, keep[path], mspecs[path], mesh)
        if g is None:
            grads[path] = new_err[path] = None
            continue
        _, (grads[path],), (new_err[path],) = C.compress_stacked([g], [O.get(err, path)])
    return {}, grads, new_err


def truncating_quantize(g):
    """A planted fault in ``compression.quantize``'s place: the codes cast
    to int8 without rounding (a cast truncates)."""
    flat = g.float().reshape(-1)
    blocks = torch.nn.functional.pad(flat, (0, (-flat.numel()) % C.BLOCK)).reshape(-1, C.BLOCK)
    scale = blocks.abs().amax(dim=1) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    return torch.clamp(blocks / scale[:, None], -127, 127).to(torch.int8), scale


#: the cases whose rules the planted compression runs under
MESH_CODES = ("tiny_fsdp_compress", "mix_compress")
FAULTS = {"seed_unscaled": "tiny_fsdp", "gather_no_sum": "mix_xla", "no_backward": "mix_xla",
          "none_as_zeros": "mix_xla", "per_shard_compress": "tiny_fsdp_compress",
          "truncated_codes": "tiny_fsdp_compress", "row_sum_no_backward": "tiny_fsdp",
          "seq_gather_no_sum": "tiny_fsdp_sp"}
#: the tensor-axis faults: each runs the case's STEPS steps, held to the
#: reference's jit and to the one-process step as the case is
TP_FAULTS = ("row_sum_no_backward", "seq_gather_no_sum")


def run_rank(rank, group, layout, params_path):
    torch.set_num_threads(1)
    with np.load(params_path) as f:
        flat = dict(f)
    out = {"cases": {name: run_case(name, flat, rank) for name in CASES}}
    out["adjoints"] = adjoints(rank)
    out["fused_layer"] = fused_layer_grads(rank)
    out["round_trip_saves"] = round_trip_saves(rank)
    out["faults"] = {fault: planted(name, flat, rank, fault) for fault, name in FAULTS.items()}
    out["mesh_codes"] = {name: mesh_codes(name, flat, rank) for name in MESH_CODES}
    return out


# ------------------------------------- the JAX side: this file as a script
def jax_main(out: str, params_out: str, parts) -> None:
    """The initial parameters and tokens of every case to ``params_out``
    first (unless it is "-"), then each case of ``parts``: two steps of the
    reference's sharded jit on 8 forced host devices. Saved to ``out``."""
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.configs import get_smoke_config as j_smoke
    from repro.dist import sharding as JSH
    from repro.models import model as JM
    from repro.train import optimizer as JO
    from repro.train import train_step as JTS

    assert jax.device_count() >= 8, jax.devices()
    cfgs = {name: case_cfg(j_smoke(CASES[name][0]), name) for name in CASES}
    init = {name: JM.init_params(jax.random.key(0), cfg) for name, cfg in cfgs.items()}
    if params_out != "-":
        flat = {}
        for name, p in init.items():
            flat_tree(jax.tree.map(np.asarray, p), f"params{SEP}{name}", flat)
            flat[f"tokens{SEP}{name}"] = tokens(name, cfgs[name].vocab)
        tmp = params_out + ".tmp.npz"
        np.savez(tmp, **flat)
        os.replace(tmp, params_out)

    results = {}
    for name in parts:
        _, shape, kw, mb, _, _ = CASES[name]
        cfg = cfgs[name]
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape), ("data", "model"))
        JSH.set_active(JSH.ShardRules(**kw), mesh)
        rules = JSH.active()[0]
        oc = opt_cfg(JO.OptConfig, name)
        settings = JTS.TrainSettings(microbatches=mb, use_kernel=False)
        ps, os_, bs, _ = JTS.train_shardings(cfg, rules, oc, settings)

        def named(tree):
            return jax.tree.map(lambda sp: NamedSharding(mesh, sp), tree,
                                is_leaf=lambda x: isinstance(x, P))

        step = jax.jit(JTS.make_train_step(cfg, oc, settings),
                       in_shardings=(named(ps), named(os_), named(bs)),
                       out_shardings=(named(ps), named(os_), None))
        t = tokens(name, cfg.vocab)
        batch = jax.device_put({"tokens": t, "labels": t}, named(bs))
        p = jax.device_put(init[name], named(ps))
        s = jax.device_put(JO.init_state(init[name], oc), named(os_))
        for i in range(STEPS):
            p, s, m = step(p, s, batch)
            for key, val in m.items():
                results[f"{name}{SEP}metrics{SEP}{i}{SEP}{key}"] = np.asarray(val)
        flat_tree(jax.tree.map(np.asarray, p), f"{name}{SEP}params", results)
        flat_tree(jax.tree.map(np.asarray, s), f"{name}{SEP}opt", results)
        JSH.clear_active()
    np.savez(out, **results)


if __name__ == "__main__":
    jax_main(sys.argv[1], sys.argv[2], sys.argv[3:])


# ------------------------------------------------------------------ tests
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(per-rank results, {key: JAX result}, the initial parameters and
    tokens): the JAX subprocesses start first, one writes the parameters,
    and the 8 gloo ranks run beside them once those are there."""
    root = tmp_path_factory.mktemp("train_sharded")
    params = root / "params.npz"
    path = os.pathsep.join([str(SRC), str(TESTS), os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=path)
    procs = [subprocess.Popen([sys.executable, __file__, str(root / f"ref{i}.npz"),
                               str(params) if writes else "-", *parts],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for i, (writes, parts) in enumerate(JAX_PARTS)]
    try:
        wait_for(params, procs[0])
        ranks = LM.spawn(run_rank, 8, device="cpu", args=(str(params),))
    finally:
        logs = [proc.communicate(timeout=900)[0] for proc in procs]
    ref = {}
    for i, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, log[-6000:]
        with np.load(root / f"ref{i}.npz") as part:
            ref.update(part)
    with np.load(params) as flat:
        return ranks, ref, dict(flat)


def gathered(ranks, name):
    """Rank 0's gathered (params, opt_state), in the port's layout."""
    state = ranks[0]["cases"][name]["state"]
    return unflat(state, "params"), unflat(state, "opt")


def assert_tree_close(got, want, tol, what, skip=None, norm_of=None):
    """Every leaf within ``tol`` of ``want``'s, ||Δ|| relative to the
    leaf's norm, or to ``norm_of(path)``'s where it gives an array; the
    elements ``skip(path)`` marks are set aside."""
    want = dict(O.flatten(want))
    got = dict(O.flatten(got))
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for path, w in want.items():
        g, w = np.asarray(got[path], np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (what, path)
        keep = ~skip(path) if skip is not None else np.ones(w.shape, bool)
        ref = norm_of(path) if norm_of is not None else w
        err = float(np.linalg.norm((g - w)[keep]))
        size = float(np.linalg.norm(np.asarray(ref, np.float64)[keep]))
        assert err <= tol * size + 1e-12, (what, path, err, size)


def by_port_leaf(cfg, per_ref):
    """{port path: array}: ``per_ref(key)``, a flat array for the JAX leaf
    at ``key``, cut into the port leaves it stacks
    (``compression.by_port_leaf``)."""
    return C.by_port_leaf(lambda ref_path: per_ref(SEP.join(map(str, ref_path))),
                          TS.param_shapes(cfg), len(cfg.layer_kinds()))


def flip_masks(cfg, got, want):
    """({port path: mask} of the values whose int8 code differs between two
    runs' codes at some step, the share of the values they are), after
    checking that every code is within one of the other run's and every
    scale within MODEL_TOL."""
    assert len(got) == len(want) and set(got[0]) == set(want[0])

    def differ(key):
        out = None
        for g, w in zip(got, want):
            (gq, gs), (wq, ws) = g[key], w[key]
            assert np.abs(gq.astype(np.int32) - wq).max() <= 1, key
            np.testing.assert_allclose(gs, ws, rtol=MODEL_TOL, err_msg=key)
            d = (gq != wq).reshape(-1)
            out = d if out is None else out | d
        return out

    masks = by_port_leaf(cfg, differ)
    return masks, sum(int(m.sum()) for m in masks.values()) / sum(m.size for m in masks.values())


def flipped(cfg, got, want):
    """``flip_masks``' masks, after checking that the values whose code
    differs are at most FLIP_SHARE of all."""
    masks, share = flip_masks(cfg, got, want)
    assert share <= FLIP_SHARE, share
    return masks


def assert_state_close(cfg, got_p, got_s, p, s, codes, masks=None):
    """The parameters and the optimizer state within MODEL_TOL of the
    one-process step's (``codes``: its compressions' codes, where it
    compresses), the values ``masks`` marks set aside. The error-feedback
    state is a residual of 1/254 of its block's largest value at most, so
    an error of the gradient shows in it about a hundred times over: it is
    held relative to the gradient it was cut from, its error plus the last
    step's dequantized gradient."""
    def skip(path):
        return None if masks is None else masks[path]

    assert_tree_close(got_p, _numpy(p), MODEL_TOL, "params", masks and skip)
    assert_tree_close(got_s["mu"], _numpy(s["mu"]), MODEL_TOL, "opt",
                      masks and (lambda path: skip(path[:-1])))
    if "err" in s:
        deq = by_port_leaf(cfg, lambda key: (codes[-1][key][0].astype(np.float32)
                                             * codes[-1][key][1][:, None]).reshape(-1))
        err = _numpy(s["err"])
        assert_tree_close(got_s["err"], err, MODEL_TOL, "err", masks and skip,
                          lambda path: O.get(err, path) + deq[path])


def reference_state(ref, name):
    from repro_torch.models.convert import opt_state_from_jax

    cfg = case_cfg(get_smoke_config(CASES[name][0]), name)
    key = SAME_AS.get(name, name)
    p = params_from_jax(unflat(ref, f"{key}{SEP}params"), cfg, device="cpu")
    s = opt_state_from_jax(unflat(ref, f"{key}{SEP}opt"), cfg, device="cpu")
    return p, s


def oracle(name, flat, steps=STEPS):
    """The port's one-process step on the whole batch, ``steps`` steps, with
    the case's MoE layers in their one-process form at its mesh: (params,
    opt_state, metrics a step, routes of step 1, the codes of each step
    where the case compresses)."""
    arch, shape, _, _, _, _ = CASES[name]
    cfg = case_cfg(get_smoke_config(arch), name)
    oc = opt_cfg(O.OptConfig, name)
    p = params_from_jax(unflat(flat, f"params{SEP}{name}"), cfg, device="cpu")
    s = init_state(p, oc, name)
    t = torch.from_numpy(flat[f"tokens{SEP}{name}"]).long()
    batch = {"tokens": t, "labels": t}
    real = TMOE.moe_apply_auto
    if cfg.moe is not None and cfg.moe.num_experts % shape[1] == 0:
        TMOE.moe_apply_auto = lambda pp, x, c: TMOE.moe_apply_ep_plain(pp, x, c, *shape)
    elif cfg.moe is not None:
        TMOE.moe_apply_auto = lambda pp, x, c: TMOE.moe_apply_tp_plain(pp, x, c, *shape)
    SH.clear_active()
    try:
        step = TS.make_train_step(cfg, oc, settings_of(name))
        metrics, routes = [], None
        with recording_codes(C, "compress_tree") as codes:
            for i in range(steps):
                with TMOE.recording_routes() as rec:
                    p, s, m = step(p, s, batch)
                if i == 0:
                    routes = [(idx.numpy(), keep.numpy()) for idx, keep, _ in rec[:n_moe(cfg)]]
                metrics.append({k: float(v) for k, v in m.items()})
    finally:
        TMOE.moe_apply_auto = real
    return p, s, metrics, routes, codes


@pytest.fixture(scope="module")
def oracles(runs):
    torch.set_num_threads(1)
    _, _, flat = runs
    return {name: oracle(name, flat) for name in CASES}


def _numpy(tree):
    return O.unflatten(tree, [x.numpy() for _, x in O.flatten(tree)])


def assert_matches_reference(ref, name, results):
    """``results``, every rank's ``run_case`` of ``name`` (rank 0's with the
    gathered state), against the reference's jit of the case."""
    want_p, want_s = reference_state(ref, name)
    got_p, got_s = unflat(results[0]["state"], "params"), unflat(results[0]["state"], "opt")
    assert_tree_close(got_p, _numpy(want_p), MODEL_TOL, "params")
    assert_tree_close(got_s["mu"], _numpy(want_s["mu"]), MODEL_TOL, "opt")
    assert int(got_s["step"]) == int(want_s["step"]) == STEPS
    key = SAME_AS.get(name, name)
    for res in results:
        for i, m in enumerate(res["metrics"]):
            for k in ("loss", "grad_norm"):
                want = float(ref[f"{key}{SEP}metrics{SEP}{i}{SEP}{k}"])
                assert abs(m[k] - want) <= LOSS_TOL * abs(want), (name, i, k, m[k], want)
            assert set(m) == {k.split(SEP)[-1] for k in ref
                              if k.startswith(f"{key}{SEP}metrics{SEP}{i}{SEP}")}


@pytest.mark.parametrize("name", REF_CASES)
def test_sharded_step_matches_the_reference_jit(runs, name):
    """Two steps, gathered: every leaf of the parameters and the optimizer
    state within MODEL_TOL of the reference's sharded jit, loss and
    grad_norm within LOSS_TOL at each step, on every rank."""
    ranks, ref, _ = runs
    assert_matches_reference(ref, name, [r["cases"][name] for r in ranks])


@pytest.mark.parametrize("fault", TP_FAULTS)
def test_planted_tp_faults_fail_the_reference_jit(runs, oracles, fault):
    """A row block's output whose backward leaves each rank its own
    cotangent (no sum over the tensor axis), and under ``seq_parallel`` a
    sequence gather whose backward takes the rank's block without the
    sum: each moves the two steps off the reference's jit and off the
    one-process step (the unfaulted cases hold both, above). A column
    block's input is the identity both ways: these are the sums that its
    copies' partial cotangents meet."""
    ranks, ref, _ = runs
    name = FAULTS[fault]
    results = [r["faults"][fault] for r in ranks]
    assert all("error" not in res for res in results), results[0]
    with pytest.raises(AssertionError):
        assert_matches_reference(ref, name, results)
    p, s, metrics, _, codes = oracles[name]
    assert _fails_comparison(name, results[0], p, s, metrics[0], codes)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_the_one_process_step(runs, oracles, name):
    """The same against the port's one-process step; where the case
    compresses, each step's codes within one of its (the values whose code
    differs, at most FLIP_SHARE, set aside: ``flipped``) and the
    error-feedback state too (``assert_state_close``); the routes and drops
    of step 1 exact, shard by shard; every rank's metrics the same."""
    ranks, _, _ = runs
    p, s, metrics, routes, codes = oracles[name]
    cfg = case_cfg(get_smoke_config(CASES[name][0]), name)
    got_p, got_s = gathered(ranks, name)
    assert ("err" in got_s) == ("err" in s) == (name in COMPRESS)
    assert len(codes) == len(ranks[0]["cases"][name]["codes"]) == (STEPS if name in COMPRESS
                                                                   else 0)
    masks = flipped(cfg, ranks[0]["cases"][name]["codes"], codes) if codes else None
    assert_state_close(cfg, got_p, got_s, p, s, codes, masks)
    for r in ranks:
        assert r["cases"][name]["metrics"] == ranks[0]["cases"][name]["metrics"]
        for i, m in enumerate(r["cases"][name]["metrics"]):
            for k, want in metrics[i].items():
                assert abs(m[k] - want) <= LOSS_TOL * abs(want) + 1e-7, (name, i, k, m[k], want)
    moe = get_smoke_config(CASES[name][0]).moe
    if moe is None:
        assert not routes and ranks[0]["cases"][name]["routes"] is None
        return
    shape = CASES[name][1]
    ep = moe.num_experts % shape[1] == 0
    # EP: rank r routes token shard r (data-major); TP: a data shard a model group
    shards = ranks if ep else ranks[::shape[1]]
    for layer, (idx, keep) in enumerate(routes):
        np.testing.assert_array_equal(
            np.concatenate([r["cases"][name]["routes"][layer][0] for r in shards]), idx)
        np.testing.assert_array_equal(
            np.concatenate([r["cases"][name]["routes"][layer][1] for r in shards]), keep)


def test_ep_modes_are_bit_identical(runs):
    """Only the transport differs between xla, dragonfly and
    dragonfly_overlap, in the backward too: the same bits."""
    ranks, _, _ = runs
    want = ranks[0]["cases"]["mix_xla"]["state"]
    for name in ("mix_dragonfly", "mix_overlap"):
        got = ranks[0]["cases"][name]["state"]
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(np.ascontiguousarray(got[key]).reshape(-1).view(np.uint8),
                                          np.ascontiguousarray(want[key]).reshape(-1).view(np.uint8))
        for r in ranks:
            assert r["cases"][name]["metrics"] == r["cases"]["mix_xla"]["metrics"]


def test_fsdp_places_whole_layers_on_their_holder(runs):
    """Mixtral smoke at data 2 (G = 2): each data coordinate holds one whole
    layer, its expert stacks cut 1 an expert a model rank."""
    from repro_torch.configs import get_smoke_config as smoke

    cfg = smoke("mixtral-8x7b")
    rules = SH.ShardRules(fsdp=True, data_axis_size=2, model_axis_size=4)
    pspecs, _, _, _ = TS.train_shardings(cfg, rules, O.OptConfig(), TS.TrainSettings())
    sizes = {"data": 2, "model": 4}
    for i, layer in enumerate(pspecs["stack"]):
        spec = layer["ffn"]["w_in"]
        assert spec == (SH.Holder("data", i, 2), "model", None, None)
        for d in range(2):
            got = SH.held_slices(spec, (4, 64, 128), {"data": d, "model": 3}, sizes)
            assert (got is not None) == (d == i)
            if got is not None:
                assert got[0] == slice(3, 4)


@pytest.mark.parametrize("op", ["native_all_to_all", "dragonfly_all_to_all",
                                "dragonfly_all_to_all_overlap", "all_gather", "all_reduce_sum",
                                "dragonfly_round_trip", "dragonfly_round_trip_weights"])
def test_collective_adjoints(runs, op):
    """<A x, y> = <x, Aᵀ y> summed over the 8 ranks, in float64; for the
    fused round trip, linear in x and in the weights, against both."""
    ranks, _, _ = runs
    lhs = sum(r["adjoints"][op][0] for r in ranks)
    rhs = sum(r["adjoints"][op][1] for r in ranks)
    assert abs(lhs - rhs) <= ADJOINT_TOL * max(1.0, abs(lhs)), (op, lhs, rhs)


def _fails_comparison(name, res, p, s, m, codes):
    """Whether a planted fault's steps are off the one-process step's as
    many: its state (no value set aside), its first loss or grad_norm."""
    got_p, got_s = unflat(res["state"], "params"), unflat(res["state"], "opt")
    cfg = case_cfg(get_smoke_config(CASES[name][0]), name)
    try:
        assert_state_close(cfg, got_p, got_s, p, s, codes)
        for k in ("loss", "grad_norm"):
            assert abs(res["metrics"][0][k] - m[k]) <= LOSS_TOL * abs(m[k])
    except AssertionError:
        return True
    return False


@pytest.mark.parametrize("fault", ["seed_unscaled", "gather_no_sum", "none_as_zeros",
                                   "per_shard_compress"])
def test_planted_faults_fail_the_comparison(runs, fault):
    """A seed not scaled for the model axis (the loss counted 4 times: under
    the clip the update is the same, grad_norm 4 times over), an output
    gather whose backward takes the rank's slice without the sum, a
    missing expert gradient taken as zeros (the exchange invisible to
    autograd) and a compression that quantizes each rank's shard on its
    own each move the step off the one-process step (the unfaulted step is
    within the tolerances, above)."""
    ranks, _, flat = runs
    torch.set_num_threads(1)
    p, s, (m,), _, codes = oracle(FAULTS[fault], flat, steps=1)
    res = ranks[0]["faults"][fault]
    assert "error" not in res, res
    assert _fails_comparison(FAULTS[fault], res, p, s, m, codes)
    if fault == "seed_unscaled":  # every gradient 4 times over
        np.testing.assert_allclose(res["metrics"][0]["grad_norm"], 4 * m["grad_norm"],
                                   rtol=1e-5)


def test_a_truncating_cast_exceeds_the_flip_cap(runs):
    """Codes cast to int8 without rounding (a cast truncates) put every
    code within one of the one-process step's and leave every scale as it
    was: at the codes, only FLIP_SHARE, the cap on the share of codes that
    differ, rejects it."""
    ranks, _, flat = runs
    torch.set_num_threads(1)
    name = FAULTS["truncated_codes"]
    *_, codes = oracle(name, flat, steps=1)
    cfg = case_cfg(get_smoke_config(CASES[name][0]), name)
    got = ranks[0]["faults"]["truncated_codes"]["codes"]
    _, share = flip_masks(cfg, got, codes)
    assert share > FLIP_SHARE, share
    with pytest.raises(AssertionError):
        flipped(cfg, got, codes)


def test_a_missing_gradient_raises(runs):
    """With the exchange invisible to autograd the expert stacks get no
    gradient, and the step says so instead of training them on zeros."""
    ranks, _, _ = runs
    for r in ranks:
        err = r["faults"]["no_backward"]["error"]
        assert err.startswith("RuntimeError: no gradient reached stack/0/ffn/w_"), err


@pytest.mark.parametrize("what", ["x", "router", "w_in", "w_gate", "w_out"])
def test_fused_gradients_are_dragonflys(runs, what):
    """The fused mode's MoE layer in float64: the same output bits as
    ``dragonfly``, and each gradient within ADJOINT_TOL of its (the expert
    stacks' summed over the waves: float order only), on every rank."""
    ranks, _, _ = runs
    for r in ranks:
        assert r["fused_layer"]["same_output"]
        assert r["fused_layer"]["rel"][what] <= ADJOINT_TOL, r["fused_layer"]


def test_round_trip_saves_its_arrivals_for_checkpoint(runs):
    """With grad the fused round trip saves its weight and each wave's
    arrivals through the saved-tensor hooks, so a non-reentrant checkpoint
    frees them and its recompute makes them again (the gradients keep
    their bits); without grad it saves nothing."""
    ranks, _, _ = runs
    for r in ranks:
        got = r["round_trip_saves"]
        assert got["with_grad"]["waves"] >= 2, got
        assert got["with_grad"]["packed"] == 1 + got["with_grad"]["waves"], got
        assert got["no_grad"] == {"packed": 0, "waves": got["with_grad"]["waves"]}, got
        assert got["checkpoint_same_grads"], got


@pytest.mark.parametrize("name", MESH_CODES)
def test_mesh_codes_are_compress_trees(runs, name):
    """The mesh's compression of planted whole gradients and errors gives,
    on every rank, ``compression.compress_tree``'s codes and scales bit for
    bit, and the rank's pieces of its dequantized gradient and new error.
    TinyLlama smoke's stacked norm scales are one 128-value block whose two
    layers FSDP places on different data coordinates."""
    ranks, _, flat = runs
    cfg = case_cfg(get_smoke_config(CASES[name][0]), name)
    grads, errs = planted_grads(cfg)
    period = len(cfg.layer_kinds())
    codes, new_err = C.compress_tree(grads, errs, period)
    deq = C.decompress_tree(codes, grads, period)
    rules = SH.ShardRules(**CASES[name][2], data_axis_size=2, model_axis_size=4)
    specs = TS.train_shardings(cfg, rules, opt_cfg(O.OptConfig, name), settings_of(name))
    sizes = {"data": 2, "model": 4}
    if name == "tiny_fsdp_compress":
        norms = [O.get(specs[0], ("stack", i, "norm1", "scale"))[0] for i in range(2)]
        assert [h.index(sizes) for h in norms] == [0, 1], norms
        q, _ = codes[("stack", 0, "norm1", "scale")]
        assert q.shape == (1, C.BLOCK) and 2 * cfg.d_model <= C.BLOCK
    for r in ranks:
        got = r["mesh_codes"][name]
        assert set(got["codes"]) == {SEP.join(map(str, k)) for k in codes}
        for key, (q, sc) in codes.items():
            gq, gs = got["codes"][SEP.join(map(str, key))]
            np.testing.assert_array_equal(gq, q.numpy())
            np.testing.assert_array_equal(gs.view(np.uint32), sc.numpy().view(np.uint32))
        for path, _ in O.flatten(grads):
            key = SEP.join(map(str, path))
            for what, whole, spec in (("grads", O.get(deq, path), O.get(specs[1]["mu"], path)["m"]),
                                      ("err", O.get(new_err, path), O.get(specs[1]["err"], path))):
                cut = SH.held_slices(spec, whole.shape, got["coords"], sizes)
                if cut is None:
                    assert got[what][key] is None, (what, path)
                else:
                    np.testing.assert_array_equal(got[what][key].view(np.uint32),
                                                  whole[cut].numpy().view(np.uint32))


def test_seq_parallel_leaves_the_decode_as_it_was(tmp_path):
    """The decode does not run a member's train form (the reference's
    decode ignores the field too): with ``seq_parallel`` the dry run's
    decode cell counts what the default cell counts."""
    from repro_torch.launch import dryrun as D

    plain = D.analyze_cell("tinyllama-1.1b", "decode_32k", False, out_dir=tmp_path)
    cell = D.analyze_cell("tinyllama-1.1b", "decode_32k", False, variant={"seq_parallel": True},
                          tag="seq_parallel", out_dir=tmp_path)
    assert plain["status"] == cell["status"] == "ok", cell
    for key in ("memory", "cost", "collectives"):
        assert cell[key] == plain[key], key


def test_refuses_without_an_active_mesh():
    cfg = get_smoke_config("tinyllama-1.1b")
    SH.clear_active()
    step = TS.make_sharded_train_step(cfg, O.OptConfig(), TS.TrainSettings())
    with pytest.raises(RuntimeError, match="set_active"):
        step({}, {}, {})
