"""Paper Fig 4 vs Fig 5: the two classic P-chase methods CONTRADICT each
other on the Kepler texture L1 (the motivation for fine-grained P-chase).

The port's twin of ``benchmarks/fig4_5_classic_contradiction.py``.
"""

from __future__ import annotations

from repro_torch.benchmarks.common import timed
from repro_torch.bench import Context, Metric, experiment, info
from repro_torch.core import classic, devices
from repro_torch.core.pchase import saavedra1992, wong2010

TRUTH = "b=32 T=4 a=96"


@experiment(
    title="Classic P-chase methods contradict each other on the texture L1",
    section="§3.2",
    artifact="Fig 4/5",
    devices=("GTX780",),
    tags=("cache", "pchase", "classic"),
    expected={
        "Ground truth (texture L1)": TRUTH,
        "Saavedra1992 vs Wong2010": "the two classic methods report "
                                    "different line sizes and set counts",
    })
def run(ctx: Context) -> list[Metric]:
    be = devices.sim_cache_backend("kepler_texture_l1")

    def saav():
        curve = saavedra1992(be, 48 << 10, [2 ** p for p in range(5, 12)])
        return classic.interpret_saavedra(curve, 48 << 10, 12 << 10)

    def wong():
        sizes = list(range(12 << 10, (12 << 10) + 640, 32))
        curve = wong2010(be, sizes, 32)
        return classic.interpret_wong(curve, 12 << 10)

    sv, us1 = timed(saav)
    wg, us2 = timed(wong)
    disagree = (sv.line_bytes != wg.line_bytes or sv.num_sets != wg.num_sets)
    return [
        info("saavedra1992", f"b={sv.line_bytes} T={sv.num_sets} "
             f"a={sv.assoc:g}", detail=f"truth {TRUTH}", us=us1),
        info("wong2010", f"b={wg.line_bytes} T={wg.num_sets} "
             f"a={wg.assoc:g}", detail=f"truth {TRUTH}", us=us2),
        Metric("methods_disagree", disagree, True, cmp="eq",
               detail=f"b {sv.line_bytes} vs {wg.line_bytes}; "
                      f"T {sv.num_sets} vs {wg.num_sets}"),
        # neither classic method recovers the true structure (the paper's
        # point): at least one parameter is wrong for each
        Metric("saavedra_wrong", (sv.line_bytes, sv.num_sets) != (32, 4),
               True, cmp="eq"),
        Metric("wong_wrong", (wg.line_bytes, wg.num_sets) != (32, 4),
               True, cmp="eq"),
    ]
