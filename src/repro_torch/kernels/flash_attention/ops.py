"""Public GQA attention entry: takes the (B, S, H, D) layout and dispatches
to an implementation:

    impl="kernel" — the CUDA kernel on a card (query head h reads KV head
                    h // G in place), its plain torch version on the CPU
    impl="naive"  — the materialised-score oracle

The JAX package's ``impl="xla"`` (chunked scans) has no counterpart: it is
the same recurrence as the kernel's plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention, flash_attention_plain)
from repro_torch.kernels.flash_attention.ref import attention_ref

IMPLS = ("kernel", "naive")


def _naive_4d(q, k, v, causal, window, scale):
    """(B, H, S, D) operands, scores and softmax in float32."""
    Sq, Sk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def gqa_attention_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: int | None = None,
                       impl: str = "kernel") -> torch.Tensor:
    """q (B, Sq, Hq, D), k (B, Sk, Hkv, D), v (B, Sk, Hkv, Dv) -> (B, Sq, Hq, Dv);
    the scale is 1/sqrt(D)."""
    Hq, D = q.shape[2], q.shape[3]
    Hkv = k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"{Hkv} KV heads do not divide {Hq} query heads")
    if impl == "kernel":
        return flash_attention(q, k, v, causal=causal, window=window)
    if impl != "naive":
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    G = Hq // Hkv
    q4 = q.transpose(1, 2)  # (B, Hq, Sq, D)
    k4 = k.repeat_interleave(G, dim=2).transpose(1, 2)
    v4 = v.repeat_interleave(G, dim=2).transpose(1, 2)
    return _naive_4d(q4, k4, v4, causal, window, 1.0 / (D ** 0.5)).transpose(1, 2)


def gqa_attention(q, k, v, *, causal=True, window=None, use_kernel=True):
    """Boolean entry: use_kernel=True is ``impl="kernel"``, False the
    materialising oracle."""
    return gqa_attention_impl(q, k, v, causal=causal, window=window,
                              impl="kernel" if use_kernel else "naive")


__all__ = [
    "gqa_attention",
    "gqa_attention_impl",
    "flash_attention",
    "flash_attention_plain",
    "attention_ref",
]
