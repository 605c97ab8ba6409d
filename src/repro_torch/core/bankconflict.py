"""Shared-memory bank-conflict model (paper §6.2, Table 8, Figs 17–19).

A copy of ``repro/core/bankconflict.py`` for the port: numpy and the
standard library only, nothing of ``repro``.

A warp of 32 threads reads ``sdata[tid * stride]`` (Listing 4).  Words map
to (bank, row) per generation:

* Fermi / Maxwell (4 B banks):   bank = w mod 32,        row = w // 32
* Kepler 4-byte mode (8 B banks): bank = w mod 32,       row = w // 64
  (words w and w+32 share an 8-byte row — stride 2 is conflict-free, Fig 18)
* Kepler 8-byte mode:             bank = (w // 2) mod 32, row = w // 64

The conflict degree is the max number of *distinct rows* any bank must
serve; access latency grows ≈ linearly with it (Table 8), except Maxwell,
whose hardware fix flattens the slope (the paper's headline Maxwell
finding).

The TPU analogue: VMEM is physically (sublanes × lanes)-tiled; a strided
gather makes one lane serve many rows, serializing the VPU the same way.
``tpu_conflict_degree`` reuses the identical row-counting model with
lanes=128, and is validated against the Pallas strided-gather kernel.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.devices import BANK_CONFLICT_LATENCY

WARP = 32


def _degree(words: np.ndarray, bank_of, row_of) -> int:
    banks = bank_of(words)
    rows = row_of(words)
    degree = 1
    for b in np.unique(banks):
        degree = max(degree, len(np.unique(rows[banks == b])))
    return int(degree)


def conflict_ways(stride: int, generation: str = "fermi",
                  mode_bytes: int = 4) -> int:
    """Conflict degree for ``sdata[tid * stride]`` over one warp."""
    words = np.arange(WARP, dtype=np.int64) * stride
    if generation in ("fermi", "maxwell", "volta"):
        return _degree(words, lambda w: w % 32, lambda w: w // 32)
    if generation == "kepler":
        if mode_bytes == 4:
            return _degree(words, lambda w: w % 32, lambda w: w // 64)
        if mode_bytes == 8:
            return _degree(words, lambda w: (w // 2) % 32, lambda w: w // 64)
    raise ValueError(f"unknown generation/mode {generation}/{mode_bytes}")


def latency_for_ways(device: str, ways: int) -> float:
    """Interpolate Table 8 (measured cycles) for any conflict degree."""
    table = BANK_CONFLICT_LATENCY[device]
    xs = np.array(sorted(table))
    ys = np.array([table[int(x)] for x in xs], dtype=np.float64)
    return float(np.interp(ways, xs, ys))


def latency_for_stride(device: str, stride: int, generation: str,
                       mode_bytes: int = 4) -> float:
    return latency_for_ways(device, conflict_ways(stride, generation, mode_bytes))


def linear_fit(device: str) -> tuple[float, float]:
    """lat ≈ base + slope·(ways−1): the paper's "almost linear" claim.

    Returns (base, slope).  Maxwell's slope is ~2 cycles/way vs Fermi's
    ~37 — the hardware-level optimization the paper reports.
    """
    table = BANK_CONFLICT_LATENCY[device]
    xs = np.array(sorted(table), dtype=np.float64)
    ys = np.array([table[int(x)] for x in xs], dtype=np.float64)
    slope, base = np.polyfit(xs - 1, ys, 1)
    return float(base), float(slope)


# ---------------------------------------------------------------------------
# TPU analogue
# ---------------------------------------------------------------------------


def tpu_conflict_degree(stride: int, lanes: int = 128, sublanes: int = 8,
                        vector_len: int | None = None) -> int:
    """Distinct (sublane-)rows the busiest lane serves for a strided gather.

    A unit-stride vector read touches each lane once (degree 1).  Stride s
    makes lane ``(i·s) mod lanes`` serve ``deg ≈ gcd(s, lanes)``-worth of
    distinct rows — the exact row-counting model above with TPU geometry.
    """
    n = vector_len or lanes
    words = np.arange(n, dtype=np.int64) * stride
    return _degree(words, lambda w: w % lanes, lambda w: w // lanes)
