"""Flash attention: online-softmax tiled attention with float32 m, l and acc.

Used by the prefill and eval-loss forward (``models.attention.gqa_train``
through ``ops.gqa_attention``). It takes the model's layout, q (B, Sq, Hq,
D) and k/v (B, Sk, Hkv, D) -> (B, Sq, Hq, D), where query head h reads KV
head h // (Hq // Hkv) in place: the GQA ``repeat`` of the JAX wrapper is
never materialised. (The JAX kernel's own (BH, S, D) layout is this one
with a single head.)

Kernel: ``csrc/flash_attention.cu`` (a block per (batch·head, q tile) at a
time, a loop over key tiles inside it; it says what bounds it on the H100).
``flash_attention`` takes the plain version for CPU tensors only; on a
CUDA tensor it launches the kernel or raises. Which of the kernel's two
bodies runs is a rule on dtype (``body_for``), never the outcome of a
build or a launch:

* ``"wgmma"`` for bf16 (the prefill's): 128-row q tiles on two
  warpgroups, 128-key K/V tiles through TMA and an mbarrier ring, both
  products on wgmma;
* ``"mma_sync"`` for float32: 64-row q tiles on mma.sync, float32 split
  into bf16 hi and lo parts.

With no key at all (Sk = 0) the output is 0 and nothing is launched.

The kernel has no backward (nor has the JAX package's): on a CUDA tensor
``flash_attention`` raises where autograd would need a gradient of q, k
or v (``refuse_grad``), rather than return an output with no gradient.
The plain version on the CPU is differentiated by autograd as usual.

The plain version, ``flash_attention_plain``, repeats the recurrence of
the JAX package's ``_flash_kernel`` tile by tile in torch: scores in
float32 times the scale, masked to NEG_INF = -1e30, running max m, sum l
and accumulator acc in float32, p cast to v's dtype before the PV
product, and l == 0 -> 1 at the end. It also stands for the JAX package's
``xla_flash.py``, which is the same recurrence.

Masked weights are exactly 0 here (``where(mask, exp(s - m), 0)``), and
both versions skip key tiles that no row of the q tile can see (past the
causal diagonal, or all of them at or beyond the sliding window). On every
row that sees at least one key this is the Pallas recurrence bit for bit:
there a masked weight is either exp(-1e30 - m) = 0, or exp(0) = 1 while m
is still -1e30 and then wiped by alpha = exp(-1e30 - m) = 0 once a real
score arrives. A row that sees no key at all (causal with a window and
Sq > Sk + window - 1) ends with l = 0 and gives 0, as ``attention_ref``
does, where the Pallas recurrence would give the mean of V over the tiles
it visits.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BODIES = {"mma_sync": 0, "wgmma": 1}
# the GQA configs' head_dim: 64 TinyLlama-1.1B, MusicGen; 96 Phi-3-mini;
# 128 OLMo-1B, Llama 3, Mixtral, Qwen2-VL, Jamba
HEAD_DIMS = (64, 96, 128)


def _check(q, k, v, window):
    if not q.dim() == k.dim() == v.dim() == 4:
        raise ValueError(f"flash_attention takes (B, S, H, D) operands, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != D
            or k.shape[2] == 0 or Hq % k.shape[2] != 0):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit k {tuple(k.shape)}"
                         f" and v {tuple(v.shape)} (KV heads must divide the query heads)")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be at least 1, got {window}")


def _key_tiles(q0: int, rows: int, Sk: int, bk: int, causal: bool, window: int | None):
    """Start of every key tile that some query row in [q0, q0 + rows) can
    see: keys past the tile's last row are masked by causality, and keys at
    or before q0 - window by the window, for every row of the tile."""
    begin, end = 0, Sk
    if causal:
        end = min(Sk, q0 + rows)
    if window is not None:
        begin = max(0, q0 - window + 1) // bk * bk
    return range(begin, end, bk)


def _plain_bh(q, k, v, causal, window, scale, bq, bk):
    """The recurrence on (BH, Sq, D) q and (BH, Sk, D) k/v."""
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    out = torch.empty_like(q)
    for q0 in range(0, Sq, bq):
        qt = q[:, q0:q0 + bq].float()
        rows = qt.shape[1]
        q_pos = torch.arange(q0, q0 + rows, device=q.device)[:, None]
        m = torch.full((BH, rows, 1), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((BH, rows, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((BH, rows, D), dtype=torch.float32, device=q.device)
        for k0 in _key_tiles(q0, rows, Sk, bk, causal, window):
            kt, vt = k[:, k0:k0 + bk], v[:, k0:k0 + bk]
            s = torch.einsum("bqd,bkd->bqk", qt, kt.float()) * scale
            k_pos = torch.arange(k0, k0 + kt.shape[1], device=q.device)[None, :]
            mask = torch.ones((rows, kt.shape[1]), dtype=torch.bool, device=q.device)
            if causal:
                mask &= q_pos >= k_pos
            if window is not None:
                mask &= (q_pos - k_pos) < window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.where(mask, torch.exp(s - m_new), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), vt.float())
            m = m_new
        l = torch.where(l == 0.0, 1.0, l)  # rows that see no key -> zeros
        out[:, q0:q0 + rows] = (acc / l).to(out.dtype)
    return out


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int | None = None,
                          scale: float | None = None, bq: int = 256, bk: int = 256):
    """The kernel's plain torch version (module docstring); bq and bk are the
    JAX kernel's tile sizes."""
    _check(q, k, v, window)
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    if scale is None:
        scale = 1.0 / (D ** 0.5)

    def heads_first(t, rep):  # (B, S, H, D) -> (B·H·rep, S, D)
        t = t.repeat_interleave(rep, dim=2) if rep > 1 else t
        return t.transpose(1, 2).reshape(-1, t.shape[1], D)

    G = Hq // Hkv
    o = _plain_bh(heads_first(q, 1), heads_first(k, G), heads_first(v, G),
                  causal, window, scale, bq, bk)
    return o.reshape(B, Hq, Sq, D).transpose(1, 2)


def refuse_grad(q, k, v) -> None:
    """Raise where autograd would need a gradient of q, k or v: the kernel
    writes its output through ctypes and has no backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention's CUDA kernel has no backward, and an operand "
                           "requires grad: run under torch.no_grad(), or take the naive "
                           "attention (use_kernel=False) to differentiate")


def body_for(dtype: torch.dtype) -> str:
    """The body the kernel runs for operands of this dtype (module docstring)."""
    return "wgmma" if dtype == torch.bfloat16 else "mma_sync"


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Attention in the (B, S, H, D) layout (module docstring), bf16 or
    float32 in and out, head_dim in ``HEAD_DIMS``; scale defaults to
    1/sqrt(D). Each operand's rows must be contiguous and 16-byte aligned.
    The body follows ``body_for``. Every launch adds one to
    ``flash_attention.launches`` and to its body's entry of
    ``flash_attention.body_launches``."""
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention takes CPU or same-card CUDA tensors, got "
                         f"{q.device}, {k.device} and {v.device}")
    _check(q, k, v, window)
    refuse_grad(q, k, v)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 operands of one dtype, "
                        f"got {q.dtype}, {k.dtype} and {v.dtype}")
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head_dim in {HEAD_DIMS}, got {D}")
    per16 = 16 // q.element_size()
    for t in (q, k, v):
        if t.stride(3) != 1 or any(s % per16 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError("flash_attention takes operands whose rows are contiguous "
                             "and 16-byte aligned")
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if Sk == 0:
        return out.zero_()
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    body = body_for(q.dtype)
    lib = build.load("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, Hq, Hkv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            int(causal), 0 if window is None else int(window), ctypes.c_float(scale),
            _DTYPES[q.dtype], BODIES[body], torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash_attention launch")
    flash_attention.launches += 1
    flash_attention.body_launches[body] += 1
    return out


flash_attention.launches = 0
flash_attention.body_launches = dict.fromkeys(BODIES, 0)
