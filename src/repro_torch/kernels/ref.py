"""Plain oracles for the port's kernels: twins of ``repro/kernels/ref.py``
(numpy for the chase, PyTorch for the rest)."""

from __future__ import annotations

import numpy as np
import torch


def pchase_ref(array: np.ndarray, iterations: int, start: int = 0) -> np.ndarray:
    """Serial pointer chase; the exact trace the kernel must reproduce."""
    out = np.empty(iterations, dtype=np.int32)
    j = int(start)
    a = np.asarray(array)
    for t in range(iterations):
        j = int(a[j])
        out[t] = j
    return out


def memcpy_ref(x: torch.Tensor) -> torch.Tensor:
    return x


def strided_ref(x: torch.Tensor, stride: int) -> torch.Tensor:
    n = x.shape[0]
    idx = (np.arange(n) * stride) % n
    return x[torch.from_numpy(idx).to(x.device)]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  num_q_heads: int, num_kv_heads: int,
                  causal: bool = True, scale: float | None = None
                  ) -> torch.Tensor:
    """Materialized-softmax attention; q: (B·H, S, D), k/v: (B·Hkv, S, D)."""
    bh, sq, d = q.shape
    batch = bh // num_q_heads
    group = num_q_heads // num_kv_heads
    scale = float(scale if scale is not None else d ** -0.5)
    # expand kv to one row per q head
    kv_idx = torch.from_numpy(np.repeat(np.arange(batch * num_kv_heads).reshape(
        batch, num_kv_heads), group, axis=1).reshape(-1)).to(q.device)
    kf = k.float()[kv_idx]
    vf = v.float()[kv_idx]
    s = torch.einsum("bqd,bkd->bqk", q.float(), kf) * scale
    if causal:
        mask = torch.ones((sq, kf.shape[1]), dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, vf).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, *,
                eps: float = 1e-6) -> torch.Tensor:
    """The Pallas rmsnorm kernel's order: statistics, the product with the
    float32 scale, then one cast to ``x.dtype``. (The model's
    ``layers.rms_norm`` casts first and multiplies by the scale after.)"""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def bf16_ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """How many bfloat16 steps apart ``a`` and ``b`` are, element by
    element (both bfloat16; -0 and +0 are one value)."""
    def order(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (order(a) - order(b)).abs()


def tile_rel_rms(got: torch.Tensor, want: torch.Tensor,
                 rows: int = 64) -> float:
    """The worst relative RMS difference of ``got`` from ``want`` over the
    blocks of ``rows`` consecutive rows of each leading index: shape
    ``(B, S, D)``, blocks of ``(rows, D)``, the last one ragged. A fault
    confined to one head's tile of an attention output shows at its own
    size here, where a global relative RMS would dilute it."""
    b, s, d = want.shape
    pad = -s % rows
    g, w = (torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
            .view(b, -1, rows, d) for t in (got, want))
    diff = (g - w).pow(2).sum((2, 3))
    ref = w.pow(2).sum((2, 3))
    return (diff / ref.clamp(min=torch.finfo(torch.float32).tiny)
            ).sqrt().max().item()
