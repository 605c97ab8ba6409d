"""Paper Table 5: parameters of common GPU caches, re-derived blind by the
fine-grained P-chase analyzer from the calibrated simulators.

The port's twin of ``benchmarks/table5_cache_params.py``.
"""

from __future__ import annotations

from repro_torch.benchmarks.common import timed
from repro_torch.bench import Context, Metric, experiment
from repro_torch.core import devices, inference

# device -> [(registered sim-cache name, n_max for size search, paper row)];
# the name keys devices.SIM_CACHES and the shared trace cache
CASES = {
    "GTX560Ti": [("fermi_l1_data", 64 << 10,
                  dict(size_kb=16, line_b=128, sets=32, assoc=4, lru=False))],
    "GTX780": [("kepler_texture_l1", 64 << 10,
                dict(size_kb=12, line_b=32, sets=4, assoc=96, lru=True)),
               ("kepler_readonly", 64 << 10,
                dict(size_kb=12, line_b=32, sets=4, assoc=96, lru=True))],
    "GTX980": [("maxwell_unified_l1", 128 << 10,
                dict(size_kb=24, line_b=32, sets=4, assoc=192, lru=True))],
}

FERMI_WAY_PROBS = [1 / 6, 1 / 6, 1 / 6, 1 / 2]        # Fig 11


@experiment(
    title="Common cache parameters, recovered blind",
    section="§4.3–4.5",
    artifact="Table 5",
    devices=("GTX560Ti", "GTX780", "GTX980"),
    tags=("cache", "pchase"),
    expected={
        "Fermi L1 data": "16 KB, 128 B lines, 32 sets, 4-way, non-LRU "
                         "(way probs 1/6, 1/2, 1/6, 1/6)",
        "Kepler texture L1": "12 KB, 32 B lines, 4 sets, 96-way, LRU, "
                             "set bits 7–8",
        "Kepler read-only data": "12 KB, 32 B lines, 4 sets, 96-way, LRU",
        "Maxwell unified L1": "24 KB, 32 B lines, 4 sets, 192-way, LRU",
    })
def run(ctx: Context) -> list[Metric]:
    metrics: list[Metric] = []
    for label, n_max, exp in CASES[ctx.device.name]:
        be = devices.sim_cache_backend(label)
        if ctx.quick:
            # size + line only: the two cheap stage-1 searches
            size, us1 = timed(inference.find_cache_size, be, n_max=n_max,
                              granularity=1 << 10)
            line, us2 = timed(inference.find_line_size, be, size,
                              max_line=4096, granularity=1 << 10)
            metrics += [
                Metric(f"{label}/size_kb", size >> 10, exp["size_kb"],
                       cmp="eq", unit="KB", us=us1),
                Metric(f"{label}/line_bytes", line, exp["line_b"],
                       cmp="eq", unit="B", us=us2),
            ]
            continue
        params, us = timed(inference.dissect, be, n_max=n_max, max_line=4096)
        metrics += [
            Metric(f"{label}/size_kb", params.size_bytes >> 10,
                   exp["size_kb"], cmp="eq", unit="KB", us=us),
            Metric(f"{label}/line_bytes", params.line_bytes, exp["line_b"],
                   cmp="eq", unit="B"),
            Metric(f"{label}/num_sets", params.num_sets, exp["sets"],
                   cmp="eq"),
            Metric(f"{label}/assoc", params.assoc, exp["assoc"], cmp="eq"),
            Metric(f"{label}/is_lru", params.is_lru, exp["lru"], cmp="eq",
                   detail=params.summary()),
        ]
    if ctx.device.name == "GTX560Ti" and not ctx.quick:
        # Fig 11 way-probability estimate for the Fermi non-LRU policy
        rep, us = timed(inference.detect_replacement,
                        devices.sim_cache_backend("fermi_l1_data"),
                        16 << 10, 128, passes=800)
        probs = sorted(rep.way_probs)
        err = max(abs(p - e) for p, e in zip(probs, sorted(FERMI_WAY_PROBS)))
        metrics.append(Metric(
            "fermi_l1_way_probs/max_abs_err", round(err, 4), 0.05, cmp="le",
            us=us, detail=f"sorted={[round(p, 3) for p in probs]} "
            f"expect={[round(p, 3) for p in sorted(FERMI_WAY_PROBS)]}"))
    return metrics
