"""Checkpointing: sharded-friendly npz snapshots with manifest, step
provenance, integrity digests, atomic rename, and retention.

The port of ``repro.train.checkpoint``, on the same on-disk format:
``arrays.npz`` with ``|``-joined keys (tuples and lists as ``__i``),
``manifest.json`` with the file's sha256 digest, written in a temporary
directory and renamed into place, the newest ``keep`` kept. Leaves may be
torch tensors (taken to the host), numpy arrays or Python scalars. numpy
has no bfloat16, so a bf16 tensor is stored as its uint16 bits and its key
listed under ``"bfloat16"`` in the manifest; ``restore`` gives it back as a
bf16 tensor with the same bits, and every other leaf as a numpy array.
The port's trees hold one array a layer (``params["stack"][i]``) where
the JAX package's hold one stacked array a member, so the two packages'
checkpoints share the format, not the layout.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch.train.optimizer import flatten, unflatten

_DIGEST_CHUNK = 1 << 24


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}__{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("__") for k in node):
            idx = sorted(node, key=lambda s: int(s[2:]))
            return tuple(fix(node[k]) for k in idx)
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def _to_numpy(v):
    """-> (array, is_bf16)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.contiguous().view(torch.int16).numpy().view(np.uint16), True
        return v.numpy(), False
    return np.asarray(v), False


def _digest(path: pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(_DIGEST_CHUNK):
            h.update(chunk)
    return h.hexdigest()


def save(ckpt_dir, step: int, state_tree, keep: int = 3) -> str:
    """Atomic checkpoint write: tmp dir -> rename."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    flat, bf16 = {}, []
    for k, v in _flatten(state_tree).items():
        flat[k], is_bf16 = _to_numpy(v)
        if is_bf16:
            bf16.append(k)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_"))
    try:
        arrays_path = tmp / "arrays.npz"
        np.savez(arrays_path, **{k.replace("/", "|"): v for k, v in flat.items()})
        manifest = {
            "step": step,
            "time": time.time(),
            "digest": _digest(arrays_path),
            "num_arrays": len(flat),
            "total_bytes": int(sum(v.nbytes for v in flat.values())),
        }
        if bf16:
            manifest["bfloat16"] = bf16
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        final = ckpt_dir / f"step_{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _retain(ckpt_dir, keep)
    return str(final)


def _retain(ckpt_dir: pathlib.Path, keep: int):
    ckpts = sorted(d for d in ckpt_dir.glob("step_*") if d.is_dir())
    for d in ckpts[:-keep]:
        shutil.rmtree(d, ignore_errors=True)


def latest_step(ckpt_dir) -> int | None:
    """Newest checkpoint step, or None. Only step_<int> DIRECTORIES count
    (the same filter ``_retain`` applies): stray files or unparseable
    names next to the checkpoints — a ``step_tmp`` leftover, an editor
    backup — are skipped instead of crashing the restore path."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    steps = []
    for d in ckpt_dir.glob("step_*"):
        if not d.is_dir():
            continue
        try:
            steps.append(int(d.name.split("_", 1)[1]))
        except ValueError:
            continue
    return max(steps) if steps else None


def restore(ckpt_dir, step: int | None = None, verify: bool = True):
    """-> (step, state_tree). Verifies the integrity digest by default —
    a truncated/corrupt checkpoint raises instead of silently loading."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    if verify and _digest(d / "arrays.npz") != manifest["digest"]:
        raise IOError(f"checkpoint {d} digest mismatch")
    bf16 = set(manifest.get("bfloat16", ()))
    with np.load(d / "arrays.npz") as z:
        flat = {k.replace("|", "/"): z[k] for k in z.files}
    for k in bf16:
        flat[k] = torch.from_numpy(flat[k].view(np.int16)).view(torch.bfloat16)
    return manifest["step"], _unflatten(flat)


def to_device(tree, device):
    """A restored tree (numpy arrays, bf16 tensors) as tensors on
    ``device``, tuples as lists."""
    return unflatten(tree, [torch.as_tensor(a).to(device) for _, a in flatten(tree)])
