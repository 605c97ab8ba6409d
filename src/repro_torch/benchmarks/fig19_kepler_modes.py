"""Paper Fig 18/19: Kepler 4-byte vs 8-byte shared-memory bank modes.

The port's twin of ``benchmarks/fig19_kepler_modes.py``.
"""

from __future__ import annotations

from repro_torch.bench import Context, Metric, experiment, info
from repro_torch.core import bankconflict

STRIDES = list(range(2, 33, 2))


@experiment(
    title="Kepler dual bank modes: 8-byte wins on non-power-of-two strides",
    section="§6.2",
    artifact="Fig 18/19",
    devices=("GTX780",),
    tags=("shared", "bank-conflict"),
    expected={
        "Stride 2 in 4 B mode": "conflict-free (words w and w+32 share an "
                                "8-byte row, Fig 18)",
        "8 B mode advantage": "strictly fewer conflicts on the 11 "
                              "non-power-of-two even strides in 2..32",
    })
def run(ctx: Context) -> list[Metric]:
    metrics: list[Metric] = []
    for mode in (4, 8):
        ways = [bankconflict.conflict_ways(s, "kepler", mode)
                for s in STRIDES]
        lat = [int(round(bankconflict.latency_for_ways("GTX780", w)))
               for w in ways]
        metrics.append(info(
            f"latency_{mode}B_mode",
            " ".join(f"s{s}:{l}" for s, l in zip(STRIDES, lat)), unit="cyc"))
    metrics.append(Metric(
        "stride2_conflict_free_4B", bankconflict.conflict_ways(2, "kepler", 4),
        1, cmp="eq", detail="Fig 18: stride-2 is conflict-free in 4B mode"))
    wins = sum(
        bankconflict.conflict_ways(s, "kepler", 8) <
        bankconflict.conflict_ways(s, "kepler", 4) for s in STRIDES)
    metrics.append(Metric(
        "8B_mode_wins", wins, 11, cmp="eq",
        detail=f"of {len(STRIDES)} even strides; the non-power-of-two "
               "ones (paper §6.2)"))
    return metrics
