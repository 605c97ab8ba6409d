"""Little's-law occupancy→throughput model (paper §5.1, §6.1).

A copy of ``repro/core/littles_law.py`` for the port: numpy and the
standard library only, nothing of ``repro``.

The paper explains every throughput curve (Fig 12, 15, 16) with one law:
sustained bandwidth needs `latency × bandwidth` bytes in flight.  We encode
that as a small analytic model, calibrated per device, and reuse the same
law for the TPU target (how many bytes of DMA must be outstanding to hide
HBM latency — this is what sizes the double-buffered BlockSpecs in
``repro.kernels``).

GPU-side quirks reproduced (and where they come from):

* GTX780's shared-memory throughput *decreases* with ILP while Fermi's and
  Maxwell's increase (Fig 16): Kepler's 8-byte dual-mode banks serialize a
  thread's ILP accesses, so ILP multiplies the *required* warps instead of
  the in-flight bytes (the paper computes 94 required warps vs 64 allowed).
* GTX560Ti "relies on ILP the most" (Fig 12): fewest allowed warps/SM, so
  only ILP can raise in-flight bytes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.devices import GpuSpec, TpuSpec

WARP = 32
WORD = 4


@dataclasses.dataclass(frozen=True)
class OccupancyPoint:
    num_ctas: int          # total CTAs launched
    cta_size: int          # threads per CTA
    ilp: int               # independent 4-byte loads per thread


def active_warps_per_sm(spec: GpuSpec, pt: OccupancyPoint,
                        max_ctas_per_sm: int = 16) -> float:
    ctas_per_sm = min(max_ctas_per_sm, np.ceil(pt.num_ctas / spec.sms))
    warps = ctas_per_sm * np.ceil(pt.cta_size / WARP)
    return float(min(spec.max_warps_per_sm, warps))


def global_throughput_gbps(spec: GpuSpec, pt: OccupancyPoint,
                           latency_cycles: float = 600.0) -> float:
    """Device-wide global-memory copy throughput (Fig 12 model).

    in-flight bytes/SM = warps × 32 lanes × ILP × 4 B; Little's law then
    caps throughput at in-flight / latency, and the DRAM subsystem caps it
    at the *measured* peak (Table 6 — the theoretical-vs-measured gap is
    DRAM protocol overhead the paper reports as 70–81% efficiency).
    """
    warps = active_warps_per_sm(spec, pt)
    inflight = warps * WARP * pt.ilp * WORD            # bytes per SM
    latency_s = latency_cycles / (spec.f_core_ghz * 1e9)
    bw = spec.sms * inflight / latency_s / 1e9         # GB/s
    return float(min(spec.measured_peak_gbps, bw))


def shared_throughput_gbps(spec: GpuSpec, pt: OccupancyPoint) -> float:
    """Per-SM shared-memory copy throughput (Fig 15/16 model).

    required_warps(ILP=1) = banks × bank_bytes × latency / (32 lanes × 4 B);
    Kepler's serialized dual-mode issue multiplies required warps by ILP,
    everyone else divides (ILP adds in-flight bytes).  The peak is the
    *measured* W'_SM (Table 7).
    """
    warps = active_warps_per_sm(spec, pt)
    latency = spec.shared_base_latency
    required = (spec.shared_banks * spec.bank_bytes * latency) / (WARP * WORD)
    if spec.generation == "kepler":
        occupancy = warps / (required * pt.ilp)
    else:
        occupancy = warps * pt.ilp / required
    return float(spec.measured_shared_peak_gbps * min(1.0, occupancy))


def best_occupancy(spec: GpuSpec, kind: str = "shared") -> tuple[OccupancyPoint, float]:
    """Grid-search the paper's configuration space (§6.1)."""
    best, best_pt = -1.0, None
    for cta in (32, 64, 128, 256, 512, 1024):
        for ctas_per_sm in (1, 2, 3, 4, 5, 6):
            for ilp in (1, 2, 4):
                pt = OccupancyPoint(ctas_per_sm * spec.sms, cta, ilp)
                v = (shared_throughput_gbps(spec, pt) if kind == "shared"
                     else global_throughput_gbps(spec, pt))
                if v > best:
                    best, best_pt = v, pt
    return best_pt, best


# ---------------------------------------------------------------------------
# TPU side: the same law, sizing in-flight DMA for the Pallas kernels
# ---------------------------------------------------------------------------


def tpu_required_inflight_bytes(spec=None,
                                hbm_latency_s: float | None = None) -> int:
    """Bytes of outstanding HBM→VMEM DMA needed to hide HBM latency.

    ``spec`` may be a :class:`TpuSpec`, a dissected
    :class:`~repro.core.profile.DeviceProfile`, or ``None`` (the active
    profile); the latency anchor defaults to the profile's own
    ``hbm_latency_s`` field instead of a constant baked in here."""
    from repro_torch.core import profile       # local: keep gpu-side import light
    spec = profile.resolve_spec(spec)
    if hbm_latency_s is None:
        hbm_latency_s = spec.hbm_latency_s
    return int(spec.hbm_bytes_per_s * hbm_latency_s)


def tpu_min_block_bytes(spec=None, buffers: int = 2,
                        hbm_latency_s: float | None = None) -> int:
    """Minimum BlockSpec tile size for a `buffers`-deep Pallas pipeline to
    keep the required bytes in flight (used by kernels/memcpy autotuning)."""
    from repro_torch.core import profile
    spec = profile.resolve_spec(spec)
    need = tpu_required_inflight_bytes(spec, hbm_latency_s)
    per_buffer = int(np.ceil(need / max(1, buffers - 1)))
    # round up to a whole (sublanes, lanes) f32 tile
    tile = spec.sublanes * spec.lanes * 4
    return int(np.ceil(per_buffer / tile)) * tile
