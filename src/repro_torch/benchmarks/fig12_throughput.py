"""Paper Fig 12: global-memory throughput vs (#CTAs, CTA size, ILP) —
saturation curves from the Little's-law model.

The port's twin of ``benchmarks/fig12_throughput.py``.
"""

from __future__ import annotations

from repro_torch.benchmarks.common import timed
from repro_torch.bench import Context, Metric, experiment, info
from repro_torch.core import devices, littles_law
from repro_torch.core.littles_law import OccupancyPoint

CTA_COUNTS = (1, 2, 4, 8, 16, 32, 64, 128)


def _curve(spec, cta_size, ilp):
    return [round(littles_law.global_throughput_gbps(
        spec, OccupancyPoint(n, cta_size, ilp)), 1) for n in CTA_COUNTS]


def _ilp_gain(spec) -> float:
    pt1 = OccupancyPoint(spec.sms * 16, 256, 1)
    pt4 = OccupancyPoint(spec.sms * 16, 256, 4)
    return (littles_law.global_throughput_gbps(spec, pt4) /
            littles_law.global_throughput_gbps(spec, pt1))


@experiment(
    title="Throughput saturation vs occupancy and ILP",
    section="§5.1",
    artifact="Fig 12",
    devices=("GTX560Ti", "GTX780", "GTX980"),
    tags=("throughput", "littles-law"),
    expected={
        "Saturation": "every device reaches its Table 6 measured peak "
                      "at full occupancy with ILP4",
        "ILP reliance": "GTX560Ti gains the most from ILP (fewest "
                        "allowed warps per SM)",
    })
def run(ctx: Context) -> list[Metric]:
    spec = ctx.device.spec
    c1, us1 = timed(_curve, spec, 256, 1)
    c4, us4 = timed(_curve, spec, 256, 4)
    metrics = [
        info("curve_T256_ILP1", str(c1), unit="GB/s", us=us1),
        info("curve_T256_ILP4", str(c4), unit="GB/s", us=us4),
        Metric("saturated_peak_gbps", max(c4),
               round(spec.measured_peak_gbps, 2), cmp="close", tol=0.01,
               unit="GB/s", detail="ILP4 curve max vs Table 6 measured"),
        Metric("ilp4_gain", round(_ilp_gain(spec), 2), 1.0, cmp="ge",
               detail="ILP4/ILP1 at full occupancy"),
    ]
    if ctx.device.name == "GTX560Ti":
        # cross-device claim, evaluated from the shared analytic model
        gains = {n: _ilp_gain(s) for n, s in devices.GPU_SPECS.items()}
        most = max(gains, key=gains.get)
        metrics.append(Metric(
            "most_ilp_reliant", most, "GTX560Ti", cmp="eq",
            detail=" ".join(f"{k}={v:.2f}x" for k, v in gains.items())))
    return metrics
