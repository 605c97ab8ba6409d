"""Access-trace containers shared by all P-chase backends.

A copy of ``repro/core/trace.py`` for the port, with the same fields,
properties and ``miss_mask`` rule. The paper's fine-grained P-chase
(Listing 3) outputs two arrays per run: ``s_index[]`` (the accessed array
indices) and ``s_tvalue[]`` (the per-access latencies). Every backend
normalizes its output into :class:`PChaseTrace` so that the analyzers read
any of them identically.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


@dataclasses.dataclass(frozen=True)
class PChaseConfig:
    """One (N, s, k) experiment, in *bytes* (paper Table 4 notation)."""

    array_bytes: int          # N
    stride_bytes: int         # s
    iterations: int           # k
    elem_bytes: int = 4       # basic unit of (N, s): one array element
    warmup_passes: int = 1    # passes before timing, to drain cold misses

    @property
    def num_elems(self) -> int:
        return self.array_bytes // self.elem_bytes

    @property
    def stride_elems(self) -> int:
        return max(1, self.stride_bytes // self.elem_bytes)


@dataclasses.dataclass
class PChaseTrace:
    """Fine-grained output: one latency + one index per access.

    ``indices`` are *element* indices into the chase array (the paper's
    ``s_index``); ``latencies`` are model cycles (simulator backend) or
    nanoseconds (hardware backend).  ``meta`` carries backend-specific
    extras (e.g. per-level hit/miss masks from the simulator, used only by
    tests — the analyzer never looks at them).
    """

    config: PChaseConfig
    indices: np.ndarray        # int64[k]
    latencies: np.ndarray      # float64[k]
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        self.indices = np.asarray(self.indices, dtype=np.int64)
        self.latencies = np.asarray(self.latencies, dtype=np.float64)
        if self.indices.shape != self.latencies.shape:
            raise ValueError("indices/latencies length mismatch")

    @property
    def tavg(self) -> float:
        """The only statistic classic P-chase ever sees."""
        return float(self.latencies.mean()) if self.latencies.size else 0.0

    def miss_mask(self, threshold: float | None = None) -> np.ndarray:
        """Classify accesses into hit/miss by latency.

        The fine-grained method's first analysis step: per-access latencies
        are bimodal (hit cluster vs miss cluster); anything above
        ``threshold`` is a miss.  With no threshold we split at the midpoint
        of the two extreme clusters, which is exact for simulator traces and
        robust for hardware ones.
        """
        lat = self.latencies
        if threshold is None:
            lo, hi = lat.min(), lat.max()
            if hi - lo < 1e-9:          # all hits (or all misses): no split
                return np.zeros_like(lat, dtype=bool)
            threshold = (lo + hi) / 2.0
        return lat > threshold

    def miss_count(self, threshold: float | None = None) -> int:
        return int(self.miss_mask(threshold).sum())

    def miss_rate(self, threshold: float | None = None) -> float:
        return float(self.miss_mask(threshold).mean()) if self.latencies.size else 0.0

    def missed_addresses(self, threshold: float | None = None) -> np.ndarray:
        """Distinct byte addresses whose accesses ever missed."""
        mask = self.miss_mask(threshold)
        addrs = self.indices[mask] * self.config.elem_bytes
        return np.unique(addrs)

    def is_periodic(self, period: int | None = None) -> bool:
        """Whether the *miss pattern* recurs with the array period.

        Under LRU (paper Assumption 3) sequential chasing is periodic with
        period N/s accesses (Fig 3); aperiodicity ⇒ non-LRU (§4.5).
        """
        mask = self.miss_mask()
        if period is None:
            period = self.config.num_elems // self.config.stride_elems
        if mask.size < 2 * period:
            return True  # not enough data to falsify periodicity
        tail = mask[: (mask.size // period) * period].reshape(-1, period)
        return bool((tail == tail[0]).all())
