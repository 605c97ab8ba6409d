"""Paper Fig 8/9: L2 TLB miss-rate staircase and the unequal-set structure.

The paper finds the same TLB hierarchy on all three devices (§4.4), so the
experiment is registered for each and probes the shared calibrated model.

The port's twin of ``benchmarks/fig8_tlb.py``.
"""

from __future__ import annotations

from repro_torch.benchmarks.common import timed
from repro_torch.bench import Context, Metric, experiment
from repro_torch.core import devices, inference

MB = 1 << 20


@experiment(
    title="L2 TLB reach, page size, and unequal-set structure",
    section="§4.4",
    artifact="Fig 8/9",
    devices=("GTX560Ti", "GTX780", "GTX980"),
    tags=("tlb", "pchase"),
    expected={
        "L2 TLB reach": "130 MB (65 × 2 MB pages)",
        "Page size": "2 MB",
        "Set structure": "unequal sets: one 17-way + six 8-way (Fig 9)",
        "Overflow-by-one-page misses/pass": "18 (the large set thrashes)",
    })
def run(ctx: Context) -> list[Metric]:
    be = devices.sim_cache_backend("l2_tlb")
    metrics: list[Metric] = []

    c, us = timed(inference.find_cache_size, be, n_max=512 * MB,
                  n_min=8 * MB, stride_bytes=2 * MB, granularity=2 * MB)
    metrics.append(Metric("l2_tlb_reach_mb", c // MB, 130, cmp="eq",
                          unit="MB", us=us, detail="= 65 pages"))

    page, us = timed(inference.find_line_size, be, c, stride_bytes=2 * MB,
                     granularity=256 << 10, max_line=8 * MB)
    metrics.append(Metric("page_mb", page // MB, 2, cmp="eq", unit="MB",
                          us=us))
    if ctx.quick:
        return metrics

    st, us = timed(inference.recover_set_structure, be, c, 2 * MB,
                   max_steps=80)
    metrics.append(Metric("set_structure", str(sorted(st.way_counts)),
                          str(sorted([17, 8, 8, 8, 8, 8, 8])), cmp="eq",
                          us=us, detail=f"uniform={st.uniform}"))
    metrics.append(Metric("sets_unequal", not st.uniform, True, cmp="eq"))

    # the measured miss-per-pass staircase itself (piecewise linear, Fig 8)
    def staircase():
        pts = []
        for extra in (1, 2, 9, 18, 27):
            m = inference.misses_per_pass(be, c + extra * 2 * MB, 2 * MB,
                                          passes=3)
            pts.append(round(m, 1))
        return pts

    pts, us = timed(staircase)
    metrics.append(Metric("overflow_one_page_misses", pts[0], 18.0,
                          cmp="close", tol=0.1, us=us,
                          detail=f"misses/pass at +{{1,2,9,18,27}} pages "
                                 f"= {pts}"))
    return metrics
