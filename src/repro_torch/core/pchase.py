"""P-chase measurement methods (classic + fine-grained), for the port.

A copy of the parts of ``repro/core/pchase.py`` that need no cache
simulator: the :class:`TraceBackend` contract, the index-sequence
constructors and the paper's three measurement methods.

* ``saavedra1992`` — average latency vs stride, N fixed (Fig 4).
* ``wong2010`` — average latency vs array size, stride fixed (Fig 5).
* ``fine_grained`` — the paper's contribution (§4.2, Listing 3): record the
  latency *and* the index of every single access.

All methods are backend-generic: a backend is any callable
``(PChaseConfig, indices) -> PChaseTrace``.
``repro_torch.kernels.pchase.kernel_trace_backend`` drives the CUDA
P-chase kernel behind that contract. The simulator backends of the
reference (``cache_backend``, ``_jax_cache_backend``,
``hierarchy_backend``) need ``cachesim`` and ``tracecache``; they come
with the next slice of the port (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from typing import Protocol, Sequence

import numpy as np

from repro_torch.core.trace import PChaseConfig, PChaseTrace


class TraceBackend(Protocol):
    def __call__(self, config: PChaseConfig,
                 indices: np.ndarray | None = None) -> PChaseTrace: ...


# ---------------------------------------------------------------------------
# Index-sequence construction
# ---------------------------------------------------------------------------


def uniform_chase_indices(config: PChaseConfig, passes: float = 1.0) -> np.ndarray:
    """Paper Listing 1: ``A[i] = (i + stride) % N`` chased from j=0.

    The visited sequence is simply ``(t * s) mod N`` in elements.
    """
    n, s = config.num_elems, config.stride_elems
    k = int(np.ceil(passes * n / s)) if passes else config.iterations
    return (np.arange(k, dtype=np.int64) * s) % n


def chase_from_array(array: np.ndarray, iterations: int, start: int = 0) -> np.ndarray:
    """Chase an arbitrarily-initialized array (the non-uniform-stride init
    of Fig 13b used by the latency-spectrum experiment)."""
    out = np.empty(iterations, dtype=np.int64)
    j = start
    for t in range(iterations):
        j = int(array[j])
        out[t] = j
    return out


# ---------------------------------------------------------------------------
# The three measurement methods
# ---------------------------------------------------------------------------


def fine_grained(backend: TraceBackend, array_bytes: int, stride_bytes: int,
                 iterations: int | None = None, elem_bytes: int = 4,
                 warmup_passes: int = 2, passes: float = 2.0) -> PChaseTrace:
    """The paper's method: full (index, latency) trace for one (N, s)."""
    cfg = PChaseConfig(array_bytes, stride_bytes, 0, elem_bytes, warmup_passes)
    if iterations is None:
        iterations = int(np.ceil(passes * cfg.num_elems / cfg.stride_elems))
    cfg = PChaseConfig(array_bytes, stride_bytes, iterations, elem_bytes,
                       warmup_passes)
    return backend(cfg)


def saavedra1992(backend: TraceBackend, array_bytes: int,
                 stride_list: Sequence[int], elem_bytes: int = 4,
                 passes: float = 4.0) -> dict[int, float]:
    """Classic method 1: tavg vs stride at fixed N (only averages kept)."""
    out = {}
    for s in stride_list:
        tr = fine_grained(backend, array_bytes, s, elem_bytes=elem_bytes,
                          passes=passes)
        out[s] = tr.tavg
    return out


def wong2010(backend: TraceBackend, array_bytes_list: Sequence[int],
             stride_bytes: int, elem_bytes: int = 4,
             passes: float = 4.0) -> dict[int, float]:
    """Classic method 2: tavg vs array size at fixed stride ≈ line size."""
    out = {}
    for n in array_bytes_list:
        tr = fine_grained(backend, n, stride_bytes, elem_bytes=elem_bytes,
                          passes=passes)
        out[n] = tr.tavg
    return out
