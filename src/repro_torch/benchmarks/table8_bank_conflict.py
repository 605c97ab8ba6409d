"""Paper Table 8: shared-memory latency under k-way bank conflict + the
accelerator's strided-gather analogue (model + kernel correctness).

The port's twin of ``benchmarks/table8_bank_conflict.py``. Outside quick
mode the accelerator record checks the port's strided gather against its
plain oracle on the run's torch device: on the card that launches the
CUDA kernel once a stride.
"""

from __future__ import annotations

from repro_torch.benchmarks.common import timed
from repro_torch.bench import Context, Metric, experiment
from repro_torch.core import bankconflict
from repro_torch.core.devices import BANK_CONFLICT_LATENCY

# Slopes of the linear fits to Table 8 (cycles per extra conflict way):
# Maxwell's flat ~2 cyc/way is the paper's headline hardware fix.
EXPECTED_SLOPE = {"GTX560Ti": 37.4, "GTX780": 14.1, "GTX980": 2.0}
TPU_STRIDES = (1, 2, 4, 8, 64, 128)


@experiment(
    title="Bank-conflict latency scaling and the Maxwell fix",
    section="§6.2",
    artifact="Table 8",
    devices=("GTX560Ti", "GTX780", "GTX980", "tpu_v5e"),
    tags=("shared", "bank-conflict", "tpu"),
    expected={
        "GTX560Ti 32-way latency": "1209 cycles (slope ~37 cyc/way)",
        "GTX780 32-way latency": "484 cycles (slope ~14 cyc/way)",
        "GTX980 32-way latency": "90 cycles (slope ~2 cyc/way — "
                                 "bank conflicts de-fanged)",
        "Maxwell headline": "32-way conflict costs less than 1.1x its "
                            "global L1 hit (82 cyc)",
    })
def run(ctx: Context) -> list[Metric]:
    if ctx.device.kind == "tpu":
        return _tpu_metrics(ctx)
    dev = ctx.device.name
    table = BANK_CONFLICT_LATENCY[dev]
    base, slope = bankconflict.linear_fit(dev)
    metrics = [
        Metric("latency_32way_cycles", bankconflict.latency_for_ways(dev, 32),
               table[32], cmp="close", tol=0.01, unit="cyc"),
        Metric("slope_cycles_per_way", round(slope, 1), EXPECTED_SLOPE[dev],
               cmp="close", tol=0.1,
               detail=f"base={base:.1f}cyc; "
                      f"lat(2..32way)={[table[w] for w in (2, 4, 8, 16, 32)]}"),
    ]
    if dev == "GTX980":
        metrics.append(Metric(
            "maxwell_32way_vs_l1_hit", table[32] / 82, 1.1, cmp="close",
            tol=0.05,
            detail="32-way conflict ~= a global L1 hit: the paper's "
                   "headline Maxwell finding"))
    return metrics


def _tpu_metrics(ctx: Context) -> list[Metric]:
    degrees = [bankconflict.tpu_conflict_degree(s) for s in TPU_STRIDES]
    metrics = [
        Metric("strided_conflict_degrees", str(degrees),
               str([1, 2, 4, 8, 64, 128]), cmp="eq",
               detail="rows the busiest lane serves, strides "
                      f"{list(TPU_STRIDES)}"),
    ]
    if not ctx.quick:
        import torch

        from repro_torch.kernels import ops, ref

        dev = ctx.torch_device

        def kernel_matches():
            x = torch.arange(128 * 8, dtype=torch.float32,
                             device=dev).reshape(128, 8)
            return all(torch.equal(ops.strided_gather(x, s),
                                   ref.strided_ref(x, s))
                       for s in TPU_STRIDES)

        ok, us = timed(kernel_matches)
        what = ("CUDA strided kernel" if dev.type == "cuda"
                else "strided gather's plain version")
        metrics.append(Metric("strided_kernel_matches_oracle", ok, True,
                              cmp="eq", us=us,
                              detail=f"{what} on {dev} vs the plain "
                                     "oracle"))
    return metrics
