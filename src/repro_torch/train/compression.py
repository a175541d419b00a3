"""Gradient compression: int8 block quantization with error feedback.

Composes with the A3 all-reduce: quantize -> all-reduce int8 (4× fewer
bytes on the wire) -> dequantize; the residual (quantization error) is
carried into the next step's gradient (error feedback keeps convergence).

The port of ``repro.train.compression``. The JAX package cuts each leaf
of its parameter tree into blocks of ``BLOCK`` values, and a member of
``stack`` (or the dense ``prefix``) is one leaf stacked over its layers,
so one block may span two layers. The port keeps one dict per layer, and
quantizes each stacked member over the same flattened order as the JAX
leaf (the layers of member ``m`` in group order, concatenated), so the
block boundaries and scales fall where the reference's do. The codes are
keyed by the JAX leaf's path (``("stack", m, "mixer", "wq")``); the
error-feedback state stays in the port's per-layer layout.
"""

from __future__ import annotations

import torch

from repro_torch.train.optimizer import STACKED, flatten, get, unflatten

BLOCK = 256


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 codes (nblocks, BLOCK), fp32 scales (nblocks,))."""
    flat = g.float().reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape, size) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)[:size]
    return flat.reshape(shape)


def reference_leaves(tree, period: int):
    """[(JAX path, [port paths])]: each leaf of the JAX package's layout
    and the port leaves it stacks, in group order. ``period`` is the
    stack's (``len(cfg.layer_kinds())``); the prefix is one member."""
    out, seen = [], set()
    for path, _ in flatten(tree):
        if path[0] not in STACKED:
            out.append((path, [path]))
            continue
        top, layer, rest = path[0], path[1], path[2:]
        step = period if top == "stack" else len(tree[top])
        member = layer % step
        if (top, member, rest) in seen:
            continue
        seen.add((top, member, rest))
        out.append(((top, member) + rest,
                    [(top, i) + rest for i in range(member, len(tree[top]), step)]))
    return out


def _stacked(tree, paths):
    """The float32 concatenation of the leaves at ``paths``, flattened."""
    parts = [get(tree, path).float().reshape(-1) for path in paths]
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def _split(flat, paths, like):
    out, lo = {}, 0
    for path in paths:
        ref = get(like, path)
        out[path] = flat[lo:lo + ref.numel()].reshape(ref.shape)
        lo += ref.numel()
    return out


def compress_tree(grads, err, period: int):
    """Error-feedback quantization over a gradient tree in the port's
    layout. Returns (codes, new_err): codes a dict from each JAX leaf path
    to its (q, scale) pair, new_err per layer as ``err``."""
    codes, new_err = {}, {}
    for ref_path, paths in reference_leaves(err, period):
        corrected = _stacked(grads, paths) + _stacked(err, paths)
        q, s = quantize(corrected)
        codes[ref_path] = (q, s)
        new_err.update(_split(corrected - dequantize(q, s, corrected.shape, corrected.numel()),
                              paths, err))
    return codes, unflatten(err, [new_err[path] for path, _ in flatten(err)])


def decompress_tree(codes, like, period: int):
    """The dequantized gradients in ``like``'s layout and dtypes."""
    out = {}
    for ref_path, paths in reference_leaves(like, period):
        q, s = codes[ref_path]
        size = sum(get(like, path).numel() for path in paths)
        out.update(_split(dequantize(q, s, (size,), size), paths, like))
    return unflatten(like, [out[path].to(leaf.dtype) for path, leaf in flatten(like)])


def init_error(params):
    return unflatten(params, [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                              for _, p in flatten(params)])
