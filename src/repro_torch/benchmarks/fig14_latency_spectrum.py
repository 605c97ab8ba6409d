"""Paper Fig 14: the P1–P6 global-memory latency spectrum per device, from
one non-uniform-stride fine-grained chase (Fig 13b).

The port's twin of ``benchmarks/fig14_latency_spectrum.py``.
"""

from __future__ import annotations

from repro_torch.benchmarks.common import timed
from repro_torch.bench import Context, Metric, experiment, info
from repro_torch.core import devices, spectrum

# Paper-anchored spectrum (cycles), additive from the §5.2 calibration
# constants — derived via devices.expected_spectrum (e.g. Fermi P2 = P1 +
# 288, the L1-cached L1TLB-miss penalty; Maxwell's virtually-addressed L1
# makes P1=P2=P3).  tests/test_profile.py pins the derivation against the
# paper's literal numbers.


@experiment(
    title="P1–P6 latency spectrum from one fine-grained chase",
    section="§5.2",
    artifact="Fig 14",
    devices=("GTX560Ti", "GTX780", "GTX980"),
    tags=("latency", "spectrum", "pchase"),
    expected={
        "GTX560Ti P1..P5": "96 / 384 / 812 / 564 / 1280 cycles",
        "GTX780 P1..P6": "188 / 215 / 552 / 301 / 665 / 2665 cycles",
        "GTX980 P1..P6": "82 / 82 / 82 / 1052 / 1412 / 6412 cycles "
                         "(L1 on; virtually addressed)",
        "Maxwell cold miss": "GTX980 P5 is ~2-3.5x Kepler's",
    })
def run(ctx: Context) -> list[Metric]:
    dev = ctx.device.name
    sp, us = timed(spectrum.measure_spectrum,
                   lambda: devices.make_hierarchy(dev))
    expected = devices.expected_spectrum(dev)
    metrics = [
        Metric(f"{p}_cycles", round(sp[p]), exp_cyc, cmp="close", tol=0.02,
               unit="cyc", us=us if p == "P1" else 0.0)
        for p, exp_cyc in sorted(expected.items())
    ]
    if not ctx.quick:
        sp_off, us = timed(spectrum.measure_spectrum,
                           lambda: devices.make_hierarchy(dev,
                                                          l1_enabled=False))
        metrics.append(info(
            "spectrum_L1off",
            " ".join(f"{k}={sp_off[k]:.0f}" for k in sorted(sp_off)),
            unit="cyc", us=us))
    if dev == "GTX980" and not ctx.quick:
        k = spectrum.measure_spectrum(lambda: devices.make_hierarchy("GTX780"))
        metrics.append(Metric("cold_miss_ratio_vs_kepler",
                              round(sp["P5"] / k["P5"], 2), [2.0, 3.5],
                              cmp="range",
                              detail="paper: Maxwell's cold TLB miss is "
                                     "~2-3.5x Kepler's"))
    return metrics
