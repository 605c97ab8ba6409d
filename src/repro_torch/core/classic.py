"""Interpreters for the two *classic* P-chase methods (§4.1).

A copy of ``repro/core/classic.py`` for the port. These implement how
Saavedra1992 and Wong2010 read cache parameters off their average-latency
curves, assuming the paper's Assumptions 1-3 hold.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ClassicParams:
    method: str
    cache_bytes: int | None = None
    line_bytes: int | None = None
    assoc: float | None = None
    num_sets: int | None = None


def interpret_saavedra(curve: dict[int, float], array_bytes: int,
                       cache_bytes: int) -> ClassicParams:
    """tavg–stride reading (Fig 4), N >> C.

    miss rate = s/b while s < b  ⇒  b = first stride at the max plateau;
    misses vanish once the footprint N/s fits one set  ⇒  a = N/s_drop;
    T = C/(a·b).
    """
    strides = sorted(curve)
    tmax = max(curve.values())
    tmin = min(curve.values())
    line = next((s for s in strides if curve[s] >= 0.99 * tmax), None)
    s_drop = next((s for s in strides
                   if s > (line or 0) and curve[s] <= tmin + 0.01 * (tmax - tmin)),
                  None)
    assoc = array_bytes / s_drop if s_drop else None
    num_sets = (int(round(cache_bytes / (assoc * line)))
                if assoc and line else None)
    return ClassicParams("saavedra1992", cache_bytes, line, assoc, num_sets)


def interpret_wong(curve: dict[int, float], cache_bytes: int) -> ClassicParams:
    """tavg–N reading (Fig 5), s ≈ b.

    Plateau count between min and max = number of cache "ways"; plateau
    width = line size.  (Valid only under Assumptions 1–3 — that is the
    point.)
    """
    sizes = sorted(curve)
    vals = [curve[n] for n in sizes]
    # group into plateaus of (approximately) equal tavg; levels drift by a
    # cycle or two within a plateau as N grows, so use a relative tolerance
    tol = 0.06 * (max(vals) - min(vals) or 1.0)
    plateaus: list[tuple[float, int, int]] = []   # (level, start_n, end_n)
    for n, v in zip(sizes, vals):
        if plateaus and abs(v - plateaus[-1][0]) < tol:
            plateaus[-1] = (plateaus[-1][0], plateaus[-1][1], n)
        else:
            plateaus.append((v, n, n))
    # interior plateaus (exclude all-hit floor and all-miss ceiling)
    vmin, vmax = min(vals), max(vals)
    interior = [p for p in plateaus if vmin < p[0] < vmax]
    widths = [p[2] - p[1] for p in interior if p[2] > p[1]]
    line = max(widths) + (sizes[1] - sizes[0]) if widths else None
    nways = len(interior) + 1
    num_sets = nways
    assoc = cache_bytes / (line * num_sets) if line else None
    return ClassicParams("wong2010", cache_bytes, line, assoc, num_sets)
