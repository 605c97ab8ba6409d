"""The inputs at which ``chip_smoke.py`` times two kernels on the card, and
at which the ``gpu`` tests hold the same kernels to their plain versions:
the paged decode kernel's rows at the granite-8b.chat cell's lengths, and
the batch_cache scan's probe streams."""

from __future__ import annotations

import numpy as np

#: accesses a lane in the scan's timed run
SCAN_STEPS = 1 << 16
#: accesses a lane in its plain version's time, whose step loop launches
#: some 30 PyTorch operations an access
SCAN_PLAIN_STEPS = 4096


def chat_positions(rows: int, live: int, seed: int = 0) -> list[int]:
    """Decode positions of ``rows`` slots, ``live`` of them live, drawn as
    the granite-8b.chat cell's mix draws its lengths (prompts Gamma(2,
    mean 1,216) in [16, 3,072], outputs Gamma(1.5, mean 164) in [2,
    1,024]): a live row stands a uniform share into its output. Idle rows
    get -1 (the caller points them at the scratch page). Live and idle
    rows are spread over all the slots, as the engine's free list leaves
    them."""
    rng = np.random.default_rng(seed)
    prompt = np.clip(rng.gamma(2.0, 1216 / 2.0, live), 16, 3072)
    output = np.clip(rng.gamma(1.5, 164 / 1.5, live), 2, 1024)
    pos = (prompt + rng.uniform(0, 1, live) * output).astype(int)
    slots = np.full(rows, -1)
    slots[rng.permutation(rows)[:live]] = pos
    return [int(p) for p in slots]


def scan_streams(geoms, seed: int, steps: int = SCAN_STEPS
                 ) -> list[np.ndarray]:
    """Two lanes a geometry, ``steps`` accesses each, at the probes' own
    sizes: a chase at 1.5x the structure's capacity, 2 passes with its line
    stride then 2 with a stride that does not tile (the simulator backends'
    np.resize stream), repeated; and a seeded random stream over 4x."""
    rng = np.random.default_rng(seed)
    out = []
    for g in geoms:
        c, b = g.size_bytes, g.line_bytes
        n = 3 * c // 2
        odd = 7 * b if n % (7 * b) else 5 * b
        tiled = np.resize((np.arange(-(-n // b), dtype=np.int64) * b) % n,
                          2 * -(-n // b))
        ragged = np.resize((np.arange(-(-n // odd), dtype=np.int64) * odd)
                           % n, 2 * -(-n // odd))
        out.append(np.resize(np.concatenate([tiled, ragged]), steps))
        out.append(rng.integers(0, 4 * c // b, steps).astype(np.int64) * b)
    return out
