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


def _stacked(leaves):
    """The float32 concatenation of ``leaves``, flattened."""
    parts = [x.float().reshape(-1) for x in leaves]
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def _split(flat, like: list) -> list:
    """``flat`` cut into pieces shaped as the leaves of ``like``, in order."""
    out, lo = [], 0
    for ref in like:
        out.append(flat[lo:lo + ref.numel()].reshape(ref.shape))
        lo += ref.numel()
    return out


def compress_stacked(grads: list, errs: list):
    """One JAX leaf's error-feedback quantization: ``grads`` and ``errs``
    are the port leaves it stacks, in group order. Returns ((q, scale), the
    dequantized leaves in ``grads``' dtypes, the new errors in float32)."""
    corrected = _stacked(grads) + _stacked(errs)
    q, s = quantize(corrected)
    deq = dequantize(q, s, corrected.shape, corrected.numel())
    return ((q, s), [d.to(g.dtype) for d, g in zip(_split(deq, grads), grads)],
            _split(corrected - deq, errs))


def compress_tree(grads, err, period: int):
    """Error-feedback quantization over a gradient tree in the port's
    layout. Returns (codes, new_err): codes a dict from each JAX leaf path
    to its (q, scale) pair, new_err per layer as ``err``."""
    codes, new_err = {}, {}
    for ref_path, paths in reference_leaves(err, period):
        codes[ref_path], _, errs = compress_stacked([get(grads, p) for p in paths],
                                                    [get(err, p) for p in paths])
        new_err.update(zip(paths, errs))
    return codes, unflatten(err, [new_err[path] for path, _ in flatten(err)])


def by_port_leaf(per_ref, like, period: int) -> dict:
    """{port path: piece}: ``per_ref(ref_path)``, a flat tensor or array
    for the JAX leaf at ``ref_path`` (at least as long as the leaves it
    stacks), cut into the port leaves of ``like`` that it stacks."""
    out = {}
    for ref_path, paths in reference_leaves(like, period):
        out.update(zip(paths, _split(per_ref(ref_path), [get(like, path) for path in paths])))
    return out


def decompress_tree(codes, like, period: int):
    """The dequantized gradients in ``like``'s layout and dtypes."""
    def flat(ref_path):  # padded to whole blocks: by_port_leaf cuts the leaves off the front
        q, s = codes[ref_path]
        return dequantize(q, s, (q.numel(),), q.numel())

    out = by_port_leaf(flat, like, period)
    return unflatten(like, [out[path].to(leaf.dtype) for path, leaf in flatten(like)])


def init_error(params):
    return unflatten(params, [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                              for _, p in flatten(params)])
