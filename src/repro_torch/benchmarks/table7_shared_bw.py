"""Paper Table 7 / Fig 15: shared-memory throughput per SM and the
required-vs-allowed warp analysis that explains Kepler's 37.5%.

The port's twin of ``benchmarks/table7_shared_bw.py``.
"""

from __future__ import annotations

from repro_torch.benchmarks.common import timed
from repro_torch.bench import Context, Metric, experiment, info
from repro_torch.core import devices, littles_law

WARP, WORD = 32, 4


@experiment(
    title="Shared-memory throughput and the Kepler warp gap",
    section="§6.1",
    artifact="Table 7",
    devices=("GTX560Ti", "GTX780", "GTX980"),
    tags=("throughput", "shared", "littles-law"),
    expected={
        "GTX560Ti measured W'_SM": "35.70 GB/s",
        "GTX780 measured W'_SM": "96.58 GB/s (37.5% of 257.5 GB/s — "
                                 "94 required warps vs 64 allowed)",
        "GTX980 measured W'_SM": "122.90 GB/s",
    })
def run(ctx: Context) -> list[Metric]:
    spec = ctx.device.spec
    (pt, bw), us = timed(littles_law.best_occupancy, spec, "shared")
    warps = littles_law.active_warps_per_sm(spec, pt)
    detail = (f"W_SM={spec.shared_theoretical_gbps:.2f}GB/s "
              f"best=({pt.cta_size}thr x{pt.num_ctas // spec.sms}ctas "
              f"ILP{pt.ilp}={warps:.0f}warps)")
    metrics: list[Metric] = []
    if spec.generation == "kepler":
        # Kepler's dual-mode banks serialize ILP: the model's peak is capped
        # *below* the paper's measurement; the warp-gap metric carries the
        # quantitative claim instead.
        metrics.append(Metric(
            "model_peak_gbps", round(bw, 2),
            round(spec.measured_shared_peak_gbps, 2), cmp="le",
            unit="GB/s", us=us, detail=detail))
        required = (spec.shared_banks * spec.bank_bytes *
                    spec.shared_base_latency) / (WARP * WORD)
        metrics += [
            Metric("required_warps", round(required), 94, cmp="eq",
                   detail=f"vs allowed={spec.max_warps_per_sm} -> "
                          "efficiency capped (paper: 37.5%)"),
            Metric("warp_gap_binds", required > spec.max_warps_per_sm, True,
                   cmp="eq"),
            Metric("measured_efficiency",
                   round(spec.measured_shared_peak_gbps /
                         spec.shared_theoretical_gbps, 3), 0.375,
                   cmp="close", tol=0.01,
                   detail="paper: Kepler reaches only 37.5% of W_SM"),
        ]
    else:
        metrics.append(Metric(
            "model_peak_gbps", round(bw, 2),
            round(spec.measured_shared_peak_gbps, 2), cmp="close", tol=0.01,
            unit="GB/s", us=us, detail=detail))
    metrics.append(info("theoretical_w_sm_gbps",
                        round(spec.shared_theoretical_gbps, 2), unit="GB/s"))
    return metrics
