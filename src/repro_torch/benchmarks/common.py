"""Benchmark harness conventions.

Each ``repro_torch/benchmarks/<artifact>.py`` module registers ONE
experiment with the ``repro_torch.bench`` registry via the
``@experiment`` decorator: a function ``run(ctx) -> list[Metric]`` plus
metadata (paper section, figure/table id, applicable devices, published
expected values).  The runner executes it once per device and folds the
metrics into a PASS/DEVIATION record; the legacy
``name,us_per_call,derived`` CSV rows are derived from the same metrics
(see ``repro_torch.bench.runner.records_to_rows``).

This module keeps the helpers shared by the experiment bodies.
"""

from __future__ import annotations

import time
from typing import Callable


def timed(fn: Callable, *args, **kw):
    """Call ``fn`` and return ``(result, elapsed_microseconds)``."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, (time.perf_counter() - t0) * 1e6


def seeded_params(cfg, device):
    """The serving experiments' weights: the port's ``init_params`` from a
    CPU generator seeded 0, then moved to ``device``, so a run on the card
    and a run on the CPU serve the same weights (the reference draws
    ``jax.random.key(0)``, which torch cannot reproduce). Each serving
    experiment binds this as its ``_params``."""
    import torch

    from repro_torch.models import transformer as T
    return T.init_params(cfg, torch.Generator().manual_seed(0),
                         "cpu").to(device)
