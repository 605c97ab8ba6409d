"""Plain PyTorch oracles for the port's kernels."""

from __future__ import annotations

import numpy as np
import torch


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
