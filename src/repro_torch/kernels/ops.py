"""Public entry points for the port's kernels.

Twin of ``repro/kernels/ops.py``. There is no ``interpret`` switch: each
wrapper runs its plain PyTorch version on CPU tensors and its CUDA kernel
on CUDA tensors. A function that builds its own input takes a ``device``,
cuda by default. Timings wait for the card with
``torch.cuda.synchronize()``, as the reference waits with
``block_until_ready``. Model code calls :func:`attention`, which picks
the flash kernel or the materialized reference per config
(``attention_impl``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import memcpy as _mc
from repro_torch.kernels import paged_decode as _pd
from repro_torch.kernels import pchase as _pc
from repro_torch.kernels import ref
from repro_torch.kernels import strided as _st


def _sync(x: torch.Tensor) -> None:
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


# -- pointer chase -----------------------------------------------------------


def pchase_trace(array, iterations: int, start: int = 0, *,
                 line_elems: int = 8) -> torch.Tensor:
    """A tensor stays on its device; anything else goes to the card."""
    if not isinstance(array, torch.Tensor):
        array = torch.as_tensor(np.asarray(array), device=resolve_device())
    return _pc.pchase_trace(array, start, iterations=iterations,
                            line_elems=line_elems)


def pchase_latency_slope(array, k_small: int, k_large: int, *,
                         repeats: int = 3) -> float:
    """Differential timing (DESIGN.md §4): per-access seconds from the
    wall-time slope between two iteration counts of the same serial chase."""
    times = []
    for k in (k_small, k_large):
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            _sync(pchase_trace(array, k))
            best = min(best, time.perf_counter() - t0)
        times.append(best)
    return (times[1] - times[0]) / (k_large - k_small)


# -- streaming copy ----------------------------------------------------------


def memcpy(x, *, block_rows: int = 256):
    return _mc.memcpy(x, block_rows=block_rows)


def memcpy_throughput_gbps(shape=(4096, 512), *, block_rows: int = 256,
                           dtype=torch.float32, repeats: int = 5,
                           device: str | torch.device | None = None) -> float:
    """2 · bytes / wall-time, as the paper computes copy throughput."""
    x = torch.ones(shape, dtype=dtype, device=resolve_device(device))
    _sync(memcpy(x, block_rows=block_rows))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        _sync(memcpy(x, block_rows=block_rows))
        best = min(best, time.perf_counter() - t0)
    return 2 * x.numel() * x.element_size() / best / 1e9


# -- strided gather ----------------------------------------------------------


def strided_gather(x, stride: int):
    return _st.strided_gather(x, stride=stride)


# -- attention ---------------------------------------------------------------


def flash_attention(q, k, v, *, num_q_heads: int, num_kv_heads: int,
                    causal: bool = True, scale: float | None = None,
                    block_q: int = 256, block_k: int = 256):
    return _fa.flash_attention(
        q, k, v, num_q_heads=num_q_heads, num_kv_heads=num_kv_heads,
        causal=causal, scale=scale, block_q=block_q, block_k=block_k)


def paged_decode_attention(q, k_pages, v_pages, page_table, positions, *,
                           scale: float | None = None):
    return _pd.paged_decode_attention(q, k_pages, v_pages, page_table,
                                      positions, scale=scale)


def attention(q, k, v, *, num_q_heads: int, num_kv_heads: int,
              causal: bool = True, scale: float | None = None,
              impl: str = "ref", **kw):
    """Dispatch: 'flash' (the hand-written kernel) or 'ref' (plain)."""
    if impl == "flash":
        return flash_attention(q, k, v, num_q_heads=num_q_heads,
                               num_kv_heads=num_kv_heads, causal=causal,
                               scale=scale, **kw)
    return ref.attention_ref(q, k, v, num_q_heads=num_q_heads,
                             num_kv_heads=num_kv_heads, causal=causal,
                             scale=scale)
