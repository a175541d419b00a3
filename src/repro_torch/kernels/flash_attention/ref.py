"""Plain torch oracle for flash attention (materialises the score matrix)."""

from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """q: (BH, Sq, D), k/v: (BH, Sk, D). Scores, softmax and the PV product
    in float32; rows with no visible key give 0."""
    Sq, D = q.shape[1], q.shape[2]
    Sk = k.shape[1]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    # rows that are fully masked produce uniform softmax over -1e30; zero them
    any_valid = mask.any(dim=1)[None, :, None]
    out = torch.einsum("bqk,bkd->bqd", p, v.float())
    out = torch.where(any_valid, out, 0.0)
    return out.to(q.dtype)
