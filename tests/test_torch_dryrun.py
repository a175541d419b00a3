"""The dry run (``repro_torch.launch.dryrun``) on the CPU: its inputs and
argument bytes against the JAX package's, its counters against a real
8-rank gloo step and against hand counts, K4's op on the meta device, and
the CLI at full width.

The JAX side runs this file as a script in a subprocess:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/test_torch_dryrun.py args OUT.json

compiles the reference's ``repro.launch.dryrun.lower_cell`` of each of
``ARG_CASES`` on a (2, 4) mesh and writes ``compiled.memory_analysis().
argument_size_in_bytes``; ``python tests/test_torch_dryrun.py olmo
OUT.json`` (512 forced host devices) lowers OLMo-1B's train_4k on the
multi-pod mesh with FSDP, lowering only, and writes the error the
reference raises. The gloo side spawns 8 ranks through
``launch.mesh.spawn`` (this module imports no jax at its top level, as the
children import it).
"""

import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeConfig, get_config, get_smoke_config,
                                 input_specs)
from repro_torch.dist import sharding as SH
from repro_torch.kernels.flash_attention.flash_attention import flash_attention, key_pairs
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as LM
from repro_torch.models import model as M

TESTS = pathlib.Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
REPO = TESTS.parent
AXES = ("data", "model")
MESH = (2, 4)
SEQ = 32
#: name -> (arch, kind, ShardRules changes, global batch): the reference's
#: lower_cell and the port's trace on a (2, 4) mesh, smoke widths
ARG_CASES = {
    "tiny_fsdp": ("tinyllama-1.1b", "train", {"fsdp": True}, 8),
    "mix_ep": ("mixtral-8x7b", "train", {}, 8),
    "deepseek": ("deepseek-v3-671b", "train", {}, 8),
    "tiny_prefill": ("tinyllama-1.1b", "prefill", {}, 8),
    "tiny_decode": ("tinyllama-1.1b", "decode", {}, 16),
}
#: name -> (arch, ShardRules changes): traced on meta and run on gloo
GLOO_CASES = {
    "tiny_fsdp": ("tinyllama-1.1b", {"fsdp": True}),
    "mix_fused": ("mixtral-8x7b", {"moe_collectives": "dragonfly_overlap_fused"}),
}
GLOO_RANKS = (0, 5)  # the ranks whose meta traces are held to the gloo step


def arg_case(name):
    arch, kind, kw, batch = ARG_CASES[name]
    return arch, ShapeConfig("smoke", SEQ, batch, kind), kw


def smoke_rules(kw):
    return SH.ShardRules(data_axis_size=MESH[0], model_axis_size=MESH[1], **kw)


# ------------------------------------------------- the JAX side: a script
def jax_args(out: str) -> None:
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax
    from jax.sharding import Mesh

    assert jax.device_count() >= 8, jax.devices()
    from repro.configs import get_smoke_config as j_smoke
    from repro.dist import sharding as JSH
    from repro.launch import dryrun as JD

    res = {}
    for name in ARG_CASES:
        arch, shape, kw = arg_case(name)
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(MESH), AXES)
        JSH.set_active(JSH.ShardRules(**kw), mesh)
        compiled = JD.lower_cell(j_smoke(arch), shape, mesh, JSH.active()[0], 1).compile()
        res[name] = compiled.memory_analysis().argument_size_in_bytes
        JSH.clear_active()
    pathlib.Path(out).write_text(json.dumps(res))


def jax_olmo(out: str) -> None:
    """OLMo-1B train_4k on the multi-pod mesh with FSDP through the
    reference's lower_cell: lowering only."""
    import dataclasses

    from repro.configs import SHAPES as J_SHAPES, get_config as j_config
    from repro.dist import sharding as JSH
    from repro.launch import dryrun as JD
    from repro.launch.mesh import make_production_mesh, make_rules

    mesh = make_production_mesh(multi_pod=True)
    rules = dataclasses.replace(make_rules(multi_pod=True), fsdp=True)
    JSH.set_active(rules, mesh)
    try:
        JD.lower_cell(j_config("olmo-1b"), J_SHAPES["train_4k"], mesh, rules,
                      JD.MICROBATCHES["olmo-1b"])
        err = None
    except ValueError as e:
        err = str(e)
    pathlib.Path(out).write_text(json.dumps({"error": err}))


# ------------------------------------------------- the gloo side: a rank
def gloo_rank(rank, group, layout):
    """Each case's train step on this rank of a real (2, 4) gloo mesh, its
    zero shards made by the dry run's own ``Trace.make``: the collectives
    the counters saw."""
    torch.set_num_threads(1)
    out = {}
    for name, (arch, kw) in GLOO_CASES.items():
        cfg = get_smoke_config(arch)
        rules = smoke_rules(kw)
        trace = D.trace_cell(cfg, ShapeConfig("smoke", SEQ, 8, "train"), rules, 1)
        mesh = LM.make_mesh(MESH, AXES, device="cpu")
        SH.set_active(rules, mesh)
        args = trace.make(mesh)
        with D.counting("cpu") as (counters, flops):
            trace.run(args)
        SH.clear_active()
        out[name] = {"collectives": counters.collective_bytes(),
                     "flops": float(flops.get_total_flops())}
    return out


if __name__ == "__main__":
    {"args": jax_args, "olmo": jax_olmo}[sys.argv[1]](sys.argv[2])


# ------------------------------------------------------------------ tests
def _script(tmp, what, devices):
    out = tmp / f"{what}.json"
    path = os.pathsep.join([str(SRC), str(TESTS), os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               JAX_PLATFORMS="cpu", PYTHONPATH=path)
    proc = subprocess.Popen([sys.executable, __file__, what, str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(the JAX argument bytes, the reference's OLMo error, the 8 gloo
    ranks' counts), the two JAX scripts running beside the ranks."""
    tmp = tmp_path_factory.mktemp("dryrun")
    procs = [_script(tmp, "args", 8), _script(tmp, "olmo", 512)]
    try:
        ranks = LM.spawn(gloo_rank, 8, device="cpu")
    finally:
        logs = [proc.communicate(timeout=600)[0] for proc, _ in procs]
    for (proc, _), log in zip(procs, logs):
        assert proc.returncode == 0, log[-6000:]
    return (json.loads(procs[0][1].read_text()), json.loads(procs[1][1].read_text()), ranks)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_the_reference(arch, shape):
    import jax.numpy as jnp

    from repro.configs import SHAPES as J_SHAPES, get_config as j_config, input_specs as j_specs

    want = j_specs(j_config(arch), J_SHAPES[shape])
    got = input_specs(get_config(arch), SHAPES[shape])
    assert list(got) == list(want)
    for key, w in want.items():
        assert got[key].is_meta
        assert tuple(got[key].shape) == tuple(w.shape), (key, got[key].shape, w.shape)
        want_dtype = {jnp.dtype(jnp.int32): torch.int32,
                      jnp.dtype(jnp.bfloat16): torch.bfloat16}[jnp.dtype(w.dtype)]
        assert got[key].dtype == want_dtype, key


@pytest.mark.parametrize("name", list(ARG_CASES))
def test_argument_bytes_are_the_reference_devices(sides, name):
    """The traced rank's argument bytes (parameters, optimizer state,
    batch, cache) equal ``memory_analysis().argument_size_in_bytes`` of the
    reference's compiled cell on a (2, 4) mesh."""
    want, _, _ = sides
    arch, shape, kw = arg_case(name)
    trace = D.trace_cell(get_smoke_config(arch), shape, smoke_rules(kw), 1)
    per_rank = D.rank_argument_bytes(trace.leaves, AXES, MESH)
    assert per_rank[D.heaviest_rank(per_rank)] == want[name], (per_rank, want[name])


@pytest.mark.parametrize("name", list(GLOO_CASES))
def test_meta_collectives_are_a_gloo_steps(sides, name):
    """The collective payload bytes and counts by kind that the meta trace
    counts on the fake world equal what the same counter saw on a real
    8-rank gloo step, rank by rank; and the FLOPs too."""
    _, _, ranks = sides
    arch, kw = GLOO_CASES[name]
    rules = smoke_rules(kw)
    for rank in GLOO_RANKS:
        trace = D.trace_cell(get_smoke_config(arch), ShapeConfig("smoke", SEQ, 8, "train"),
                             rules, 1)
        got = D.run_trace(trace, rules, MESH, AXES, rank)
        want = ranks[rank][name]
        assert got["collectives"] == want["collectives"], (rank, got["collectives"], want)
        assert got["flops"] == want["flops"], rank
    if name == "mix_fused":  # the round trip's waves travel point to point
        assert want["collectives"]["_counts"].get("send", 0) > 0


def test_dense_forward_flops_are_the_hand_count():
    """TinyLlama smoke's forward (naive attention) on meta: every product
    counted by hand, 2·m·n·k each."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = get_smoke_config("tinyllama-1.1b")
    B, S = 3, 40
    T, d, H, G, hd, ff, V = B * S, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.d_ff, cfg.vocab
    params = M.init_params(torch.Generator(), cfg, device="meta")
    batch = {"tokens": torch.empty((B, S), dtype=torch.int32, device="meta")}
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        M.forward_train(params, batch, cfg, use_kernel=False, remat=False)
    layer = (2 * T * d * H * hd + 2 * 2 * T * d * G * hd + 2 * T * H * hd * d  # q, k, v, o
             + 2 * 2 * B * H * S * S * hd                                      # scores, p·v
             + 3 * 2 * T * d * ff)                                             # gated MLP
    assert fc.get_total_flops() == cfg.n_layers * layer + 2 * T * d * V


def _step_gathers(rules, mesh_shape, rank):
    """TinyLlama smoke's train cell as rank ``rank`` of a fake world of
    ``mesh_shape``: {path: bytes} of each leaf the sharded step gathers to
    its compute spec at its top (``train_step._regather``' first call a
    leaf), and the trace's FLOPs."""
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS

    cfg = get_smoke_config("tinyllama-1.1b")
    paths = [path for path, _ in O.flatten(TS.param_shapes(cfg))]
    seen, real = [], TS._regather

    def record(x, frm, to, like, mesh):
        out = real(x, frm, to, like, mesh)
        seen.append(None if out is None else out.numel() * out.element_size())
        return out

    TS._regather = record
    try:
        trace = D.trace_cell(cfg, ShapeConfig("smoke", SEQ, 8, "train"), rules, 1)
        res = D.run_trace(trace, rules, mesh_shape, AXES, rank)
    finally:
        TS._regather = real
    return dict(zip(paths, seen[:len(paths)])), res["flops"]


def test_train_cell_gathers_a_quarter_of_each_dense_leaf():
    """On a fake (2, 4) world at TinyLlama smoke's train cell, the step
    gathers every attention and MLP leaf, the embedding and the
    unembedding to a quarter of the whole leaf's bytes (its model-axis
    cut), the norms whole; and the rank's FLOPs fall accordingly: under a
    third of the (2, 1) world's, where the rank computes every head."""
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS

    cfg = get_smoke_config("tinyllama-1.1b")
    like = dict(O.flatten(TS.param_shapes(cfg)))
    got, flops = _step_gathers(smoke_rules({"fsdp": True}), MESH, 0)
    whole_got, whole_flops = _step_gathers(
        SH.ShardRules(fsdp=True, data_axis_size=2, model_axis_size=1), (2, 1), 0)
    for path, nbytes in got.items():
        full = like[path].numel() * like[path].element_size()
        cut = path[-1] != "scale"
        assert nbytes == (full // MESH[1] if cut else full), (path, nbytes, full)
        assert whole_got[path] == full, path
    assert flops * 3 < whole_flops, (flops, whole_flops)


def test_prefill_flops_are_the_local_heads_hand_count():
    """TinyLlama smoke's prefill cell on rank 0 of a fake (2, 4) world: the
    products of the rank's share counted by hand, at its one query head of
    4, the one KV head it reads of 2, its ff slice and its vocabulary
    slice; K4 by its flop formula at (1 query head, 1 KV head), at a head
    dim of 64, one K4 takes."""
    import dataclasses

    cfg = dataclasses.replace(get_smoke_config("tinyllama-1.1b"), head_dim=64)
    B, S = 8 // MESH[0], SEQ
    m = MESH[1]
    T, d, hd, ff, V = B * S, cfg.d_model, cfg.head_dim, cfg.d_ff, cfg.vocab
    Hq, Hkv = cfg.n_heads // m, 1
    rules = smoke_rules({})
    trace = D.trace_cell(cfg, ShapeConfig("smoke", S, 8, "prefill"), rules, 1)
    got = D.run_trace(trace, rules, MESH, AXES, 0)
    layer = (2 * T * d * Hq * hd + 2 * 2 * T * d * Hkv * hd + 2 * T * Hq * hd * d
             + B * Hq * key_pairs(S, S, True, cfg.sliding_window) * 4 * hd
             + 3 * 2 * T * d * ff // m)
    assert got["flops"] == cfg.n_layers * layer + 2 * T * d * V // m


def test_seq_parallel_train_cell_is_ok_with_the_plain_flops(tmp_path):
    """A ``--seq-parallel`` train cell traces (``ok``) and counts the plain
    cell's FLOPs: the residual stream is cut along the sequence between
    blocks, the products are the same."""
    plain = D.analyze_cell("tinyllama-1.1b", "train_4k", False, out_dir=tmp_path)
    cell = D.analyze_cell("tinyllama-1.1b", "train_4k", False, variant={"seq_parallel": True},
                          tag="seq_parallel", out_dir=tmp_path)
    assert plain["status"] == cell["status"] == "ok", cell
    assert cell["cost"]["flops"] == plain["cost"]["flops"]
    assert cell["memory"]["peak_bytes"] < plain["memory"]["peak_bytes"]


def test_peak_tracker_counts_storages_once():
    """A scripted run: allocations, a view, frees while the view lives."""
    c = D.Counters("cpu")
    keep = torch.empty(10, dtype=torch.float32)
    assert c.hold({"a": keep, "b": [keep[2:]]}) == 40 and c.live == 40
    with c:
        a = torch.empty(100, dtype=torch.float32)           # 400
        v = a[10:20]                                        # a view: nothing new
        b = torch.empty((8, 8), dtype=torch.float64)        # 512
        assert (c.live, c.peak) == (952, 952)
        del a                                               # the view keeps it
        assert c.live == 952
        del v                                               # now it goes
        assert c.live == 552
        d = b.t().contiguous()                              # a copy: 512
        assert (c.live, c.peak) == (1064, 1064)
        b.add_(1)                                           # in place: nothing new
        del b, d
    assert (c.live, c.peak) == (40, 1064)
    assert c.bytes_accessed == 512 * 2 + 512 * 2            # the copy and the add


@pytest.mark.parametrize("dims", [(64, 64), (96, 96), (128, 128), (192, 128)])
@pytest.mark.parametrize("mask", ["causal", "window", "full"])
def test_k4_op_fake_shapes_and_flops(dims, mask):
    """K4 on the meta device: the op's output shape and dtype, and its flop
    formula counting the visible key pairs exactly (a brute-force count of
    the mask) at 2·D + 2·Dv each."""
    from torch.utils.flop_counter import FlopCounterMode

    D_, Dv = dims
    B, Sq, Hq, Hkv = 2, 300, 8, 2
    causal, window = {"causal": (True, None), "window": (True, 64), "full": (False, None)}[mask]
    q = torch.empty((B, Sq, Hq, D_), dtype=torch.bfloat16, device="meta")
    k = torch.empty((B, Sq, Hkv, D_), dtype=torch.bfloat16, device="meta")
    v = torch.empty((B, Sq, Hkv, Dv), dtype=torch.bfloat16, device="meta")
    with FlopCounterMode(display=False) as fc:
        o = flash_attention(q, k, v, causal=causal, window=window)
    assert o.is_meta and tuple(o.shape) == (B, Sq, Hq, Dv) and o.dtype == torch.bfloat16
    i, j = np.meshgrid(np.arange(Sq), np.arange(Sq), indexing="ij")
    seen = np.ones_like(i, dtype=bool)
    if causal:
        seen &= j <= i
    if window is not None:
        seen &= (i - j) < window
    assert key_pairs(Sq, Sq, causal, window) == int(seen.sum())
    assert fc.get_total_flops() == B * Hq * int(seen.sum()) * (2 * D_ + 2 * Dv)


def _experiments_dryrun():
    path = REPO / "experiments" / "dryrun"
    return sorted(p.name for p in path.iterdir()) if path.exists() else None


def test_cli_prefill_at_full_width(tmp_path, capsys):
    """TinyLlama-1.1B prefill_32k on the (16, 16) mesh, meta: ok, every
    roofline term finite and positive, K4 counted on the rank's 2 query
    heads of 32 (no score tensor), the JSON where ``--out`` says and
    nothing under experiments/dryrun/."""
    before = _experiments_dryrun()
    assert D.RESULTS_DIR == REPO / "experiments" / "dryrun_torch"
    D.main(["--arch", "tinyllama-1.1b", "--shape", "prefill_32k", "--out", str(tmp_path)])
    r = json.loads((tmp_path / "tinyllama-1.1b__prefill_32k__pod1.json").read_text())
    assert r["status"] == "ok" and r["n_chips"] == 256 and r["rank"] == 0
    rf = r["roofline"]
    for key in ("compute_s", "memory_s", "collective_s", "step_time_bound_s"):
        assert math.isfinite(rf[key]) and rf[key] > 0, (key, rf)
    assert r["memory"]["fits_80gib"] and r["memory"]["peak_bytes"] > r["memory"]["argument_bytes"]
    cfg = get_config("tinyllama-1.1b")
    heads = cfg.n_heads // 16  # the rank's query heads on the model axis of 16
    attn = 2 * cfg.n_layers * heads * key_pairs(32768, 32768, True, None) * 4 * 64
    assert r["cost"]["flops"] > attn
    assert "dryrun: " in capsys.readouterr().out
    assert _experiments_dryrun() == before


def test_multi_pod_fsdp_olmo_fails_as_the_reference(sides, tmp_path):
    """OLMo-1B train_4k on the multi-pod mesh with FSDP: the split of its
    16 stacked layers over pod·data (32) cannot be made. The port fails on
    the leaf ``tests/test_torch_train_shardings.py`` names (a layer's
    ``wq``, held whole by a ``Holder`` of 16 over 32), and the reference's
    lowering fails on the same stacked split."""
    _, olmo, _ = sides
    r = D.analyze_cell("olmo-1b", "train_4k", True, variant={"fsdp": True}, tag="fsdp",
                       out_dir=tmp_path)
    assert r["status"] == "FAILED"
    assert r["error"].startswith("ValueError: params/stack/0/mixer/wq (2048, 2048) under "
                                 "(Holder(axes=('pod', 'data'), at=0, of=16)"), r["error"]
    assert "a stacked dim of 16 does not split over ('pod', 'data') (32)" in r["error"]
    assert olmo["error"] is not None and "['stack'][0]" in olmo["error"]
    assert "should be divisible by 32, but it is equal to 16" in olmo["error"]
    plain = D.analyze_cell("olmo-1b", "prefill_32k", True, out_dir=tmp_path)
    assert plain["status"] == "ok" and plain["n_chips"] == 512
