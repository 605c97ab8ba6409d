"""Statistics of a run: the nearest-rank percentile. No statistic of the
benchmark is taken over medians of chunks or ticks."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the ``ceil(q/100 * n)``-th smallest value,
    always one of ``values``."""
    if not 0 < q <= 100:
        raise ValueError(f"percentile q must be in (0, 100], got {q}")
    vals = sorted(values)
    if not vals:
        raise ValueError("percentile of an empty sequence")
    return float(vals[math.ceil(q / 100.0 * len(vals)) - 1])

