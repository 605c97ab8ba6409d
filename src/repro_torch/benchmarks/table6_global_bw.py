"""Paper Table 6: theoretical vs achieved global-memory bandwidth, plus the
accelerator-side streaming-copy analogue (Little's law + the memcpy
kernel).

The port's twin of ``benchmarks/table6_global_bw.py``. Outside quick mode
the accelerator record times the port's memcpy on the run's torch device:
on the card that launches the CUDA kernel (three launches), on the CPU
its plain version.
"""

from __future__ import annotations

from repro_torch.benchmarks.common import timed
from repro_torch.bench import Context, Metric, experiment, info
from repro_torch.core import devices, littles_law

# Paper Table 6 achieved/theoretical efficiency band: 70–81 %.
EFFICIENCY_BAND = [0.65, 0.85]
#: the accelerator record's timed copy, float32 (4 MiB), and its block rows
COPY_SHAPE = (2048, 512)
COPY_BLOCK_ROWS = 256


@experiment(
    title="Global-memory throughput: theory, model peak, paper measurement",
    section="§5.1",
    artifact="Table 6",
    devices=("GTX560Ti", "GTX780", "GTX980", "tpu_v5e"),
    tags=("throughput", "littles-law", "tpu"),
    expected={
        "GTX560Ti achieved": "109.38 GB/s of 134.40 GB/s theoretical (81%)",
        "GTX780 achieved": "215.92 GB/s of 288.38 GB/s theoretical (75%)",
        "GTX980 achieved": "156.25 GB/s of 224.38 GB/s theoretical (70%)",
        "Efficiency band": "achieved/theoretical within 70–81 %",
    })
def run(ctx: Context) -> list[Metric]:
    if ctx.device.kind == "tpu":
        return _tpu_metrics(ctx)
    spec = ctx.device.spec
    (pt, bw), us = timed(littles_law.best_occupancy, spec, "global")
    eff = bw / spec.theoretical_gbps
    return [
        Metric("model_peak_gbps", round(bw, 2),
               round(spec.measured_peak_gbps, 2), cmp="close", tol=0.01,
               unit="GB/s", us=us,
               detail=f"theory={spec.theoretical_gbps:.2f}GB/s "
                      f"best=({pt.cta_size}thr x{pt.num_ctas}ctas "
                      f"ILP{pt.ilp})"),
        Metric("efficiency", round(eff, 3), EFFICIENCY_BAND, cmp="range",
               detail="achieved/theoretical (Table 6: 70-81%)"),
        info("theoretical_gbps", round(spec.theoretical_gbps, 2),
             unit="GB/s"),
    ]


def _tpu_metrics(ctx: Context) -> list[Metric]:
    spec = ctx.device.spec
    need = littles_law.tpu_required_inflight_bytes(spec)
    blk = littles_law.tpu_min_block_bytes(spec)
    tile = spec.sublanes * spec.lanes * 4
    metrics = [
        Metric("littles_law_inflight_kib", need / 1024,
               spec.hbm_bytes_per_s * 1e-6 / 1024, cmp="close", tol=0.01,
               unit="KiB", detail="bytes in flight to hide ~1us HBM latency"),
        Metric("min_block_tile_aligned", blk % tile == 0, True, cmp="eq",
               detail=f"block={blk / 1024:.0f}KiB tile={tile}B"),
    ]
    if not ctx.quick:
        # a 4 MiB copy: a sanity check of the kernel, far too small to
        # reach the card's memory rate
        from repro_torch.kernels import ops
        dev = ctx.torch_device
        bw, us = timed(ops.memcpy_throughput_gbps, COPY_SHAPE,
                       block_rows=COPY_BLOCK_ROWS, repeats=2, device=dev)
        what = ("the CUDA memcpy kernel" if dev.type == "cuda"
                else "the plain version")
        metrics.append(info("host_memcpy_gbps", round(bw, 2), unit="GB/s",
                            detail=f"{COPY_SHAPE} float32 copy on {dev} by "
                                   f"{what}: 2 x bytes / best of 2 wall "
                                   "times",
                            us=us))
    return metrics
