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


#: the policy codes of the batched cache engine's lanes
POLICY_CODE = {"lru": 0, "fifo": 1, "random": 2, "prob": 3}


def batch_cache_ref(ways: torch.Tensor, policy: torch.Tensor,
                    cum: torch.Tensor, sets: torch.Tensor,
                    lines: torch.Tensor, valid: torch.Tensor,
                    u: torch.Tensor) -> torch.Tensor:
    """The batched cache engine's scan, one step a loop turn over all lanes
    at once: the twin of ``repro/core/cachesim_jax.py::_lane_scan``.

    ``ways (B, T)`` int32 way counts (0 past a lane's sets), ``policy (B,)``
    int32 (:data:`POLICY_CODE`), ``cum (B, W)`` float32 cumulative way
    weights of the prob lanes, ``sets`` and ``lines (B, K)`` int32 (dense
    line ids), ``valid (B, K)`` bool, ``u (B, K)`` float32 eviction
    uniforms. Every lane starts cold. Returns the hits ``(B, K)`` bool.
    The prob victim is the first way whose cumulative weight reaches
    ``u`` times the set's total, read from ``cum`` as given (the
    reference takes a masked ``cumsum`` in the scan)."""
    b, t = ways.shape
    w = cum.shape[1]
    k = sets.shape[1]
    dev = ways.device
    lane = torch.arange(b, device=dev)
    wid = torch.arange(w, dtype=torch.int32, device=dev)[None]
    tags = torch.full((b, t, w), -1, dtype=torch.int32, device=dev)
    stamp = torch.zeros((b, t, w), dtype=torch.int32, device=dev)
    filled = torch.zeros((b, t), dtype=torch.int32, device=dev)
    clock = torch.ones(b, dtype=torch.int32, device=dev)
    hits = torch.zeros((b, k), dtype=torch.bool, device=dev)
    int_max = torch.iinfo(torch.int32).max
    lru, fifo = policy == 0, policy == 1
    rand, prob = policy == 2, policy == 3
    for step in range(k):
        s, line = sets[:, step].long(), lines[:, step]
        v, uu = valid[:, step], u[:, step]
        row_t, row_s = tags[lane, s], stamp[lane, s]
        wl, f = ways[lane, s], filled[lane, s]
        wvalid = wid < wl[:, None]
        eq = wvalid & (row_t == line[:, None])
        hit = eq.any(dim=1)
        ev_det = torch.argmin(torch.where(wvalid, row_s, int_max), dim=1)
        ev_rand = torch.minimum((uu * wl).to(torch.int32),
                                (wl - 1).clamp(min=0))
        total = cum[lane, (wl - 1).clamp(min=0).long()]
        ev_prob = torch.argmax((wvalid & (cum >= (uu * total)[:, None]))
                               .to(torch.int32), dim=1)
        evict = torch.where(rand, ev_rand,
                            torch.where(prob, ev_prob.to(torch.int32),
                                        ev_det.to(torch.int32)))
        ins = torch.where(f < wl, f, evict)
        way = torch.where(hit, torch.argmax(eq.to(torch.int32), dim=1)
                          .to(torch.int32), ins)
        do_ins = v & ~hit
        sel = wid == way[:, None]
        restamp = torch.where(lru, v, fifo & do_ins)
        tags[lane, s] = torch.where(sel & do_ins[:, None], line[:, None],
                                    row_t)
        stamp[lane, s] = torch.where(sel & restamp[:, None], clock[:, None],
                                     row_s)
        filled[lane, s] = f + (do_ins & (f < wl)).to(torch.int32)
        clock = clock + v.to(torch.int32)
        hits[:, step] = hit & v
    return hits
