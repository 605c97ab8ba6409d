"""Calibrated device models.

A copy of ``repro/core/devices.py`` for the port: numpy and the
standard library only, nothing of ``repro``.

Two families live here:

1. The paper's three GPUs (GTX560Ti / GTX780 / GTX980) expressed as
   :class:`~repro.core.cachesim.MemoryHierarchy` instances with every
   structure the paper published (Table 3, Table 5, §4–§6).  These are the
   ground truth that the fine-grained analyzer must re-derive blind.
2. The TPU v5e target (per-chip peaks used by the roofline, VMEM geometry
   used by the autotuner and the Pallas kernels).

Cycle constants for the latency spectrum are calibrated to the
relationships the paper states around Fig 14 (see inline notes); the
*structural* parameters are exact per Table 5.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.cachesim import (
    Cache,
    CacheGeometry,
    LatencyModel,
    MemoryHierarchy,
    ReplacementPolicy,
    bitfield_map,
    range_cyclic_map,
    split_bitfield_map,
)

MB = 1 << 20
KB = 1 << 10

# ---------------------------------------------------------------------------
# Structural geometries (Table 5 — exact)
# ---------------------------------------------------------------------------


def fermi_l1_data(rng=None) -> Cache:
    """16 KB, 128 B lines, 32 sets — non-LRU with way probs (1/6,1/2,1/6,1/6).

    §4.5: bits 9–11 pick the major set and 12–13 the group; bits 7–8 are
    *not* part of the set index (Assumption-2 violation #2).
    """
    geom = CacheGeometry(
        name="fermi_l1_data",
        line_bytes=128,
        way_counts=(4,) * 32,
        set_map=split_bitfield_map([(9, 3), (12, 2)]),
        replacement=ReplacementPolicy("prob", (1 / 6, 1 / 2, 1 / 6, 1 / 6)),
    )
    return Cache(geom, rng)


def kepler_texture_l1(rng=None) -> Cache:
    """12 KB, 32 B lines, 4 sets × 96 ways, set = address bits 7–8 (Fig 7)."""
    geom = CacheGeometry(
        name="kepler_texture_l1",
        line_bytes=32,
        way_counts=(96,) * 4,
        set_map=bitfield_map(7, 2),
    )
    return Cache(geom, rng)


def kepler_readonly(rng=None) -> Cache:
    """GTX780 read-only data cache: same geometry as texture L1 (§4.3)."""
    geom = CacheGeometry(
        name="kepler_readonly",
        line_bytes=32,
        way_counts=(96,) * 4,
        set_map=bitfield_map(7, 2),
    )
    return Cache(geom, rng)


def maxwell_unified_l1(rng=None) -> Cache:
    """GTX980 unified L1/texture: 24 KB, 32 B lines, 4 sets × 192 ways."""
    geom = CacheGeometry(
        name="maxwell_unified_l1",
        line_bytes=32,
        way_counts=(192,) * 4,
        set_map=bitfield_map(7, 2),
    )
    return Cache(geom, rng)


def volta_l1_data(rng=None) -> Cache:
    """TeslaV100 combined L1/shared data path (Jia et al. 2018, Table 3.1):
    128 KB at 32 B sector granularity, 4 sets × 1024 ways, LRU.

    The load unit is the 32 B *sector* (the 128 B line fills four sectors
    lazily), so the miss granularity the blind analyzer sees is 32 B — same
    observable as the Maxwell unified L1, eight times the capacity.  Set
    selection stays on address bits 7–8.
    """
    geom = CacheGeometry(
        name="volta_l1_data",
        line_bytes=32,
        way_counts=(1024,) * 4,
        set_map=bitfield_map(7, 2),
    )
    return Cache(geom, rng)


def l1_tlb(rng=None) -> Cache:
    """16-way fully-associative, 2 MB pages ⇒ 32 MB reach (§4.4)."""
    geom = CacheGeometry(
        name="l1_tlb",
        line_bytes=2 * MB,
        way_counts=(16,),
    )
    return Cache(geom, rng)


def l2_tlb(rng=None) -> Cache:
    """65 entries in UNEQUAL sets: one 17-way + six 8-way, LRU (Fig 9)."""
    ways = (17, 8, 8, 8, 8, 8, 8)
    geom = CacheGeometry(
        name="l2_tlb",
        line_bytes=2 * MB,
        way_counts=ways,
        set_map=range_cyclic_map(2 * MB, ways),
    )
    return Cache(geom, rng)


def volta_l2_tlb(rng=None) -> Cache:
    """V100 L2 TLB modeled at 128 entries in 16 EQUAL 8-way LRU sets.

    Unlike the 2015 paper's 17+6×8 structure (Fig 9), Volta's L2 TLB shows
    equal sets again (Jia et al. §3) — held-out validation that the blind
    set-structure recovery distinguishes the two regimes instead of
    pattern-matching the staircase it was developed against.
    """
    geom = CacheGeometry(
        name="volta_l2_tlb",
        line_bytes=2 * MB,
        way_counts=(8,) * 16,
    )
    return Cache(geom, rng)


def l2_data(size_bytes: int, rng=None, prefetch: bool = True) -> Cache:
    """L2 data cache (§4.6): 32 B lines, non-LRU (random model), sequential
    prefetch of ~2/3 capacity.  Associativity is 'not an integer' per the
    paper/Meltzer — we model 16 sets with the remainder folded into ways.

    ``prefetch=False`` models Volta, where the sequential DRAM→L2 streamer
    of the 2015 generations is not observable (Jia et al.) — and where a
    2/3-of-6MB reach would anyway swallow whole 2 MB pages, breaking the
    P4 phase placement of the spectrum experiment."""
    num_sets = 16
    lines = size_bytes // 32
    geom = CacheGeometry(
        name="l2_data",
        line_bytes=32,
        way_counts=(lines // num_sets,) * num_sets,
        replacement=ReplacementPolicy("random"),
        prefetch_lines=int((2 / 3) * lines) if prefetch else 0,
    )
    return Cache(geom, rng)


# ---------------------------------------------------------------------------
# Full device models
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GpuSpec:
    """Published per-device constants used by throughput/latency benchmarks."""

    name: str
    generation: str
    sms: int
    f_core_ghz: float                 # Table 7
    f_mem_mhz: float                  # Table 6
    bus_width_bits: int
    ddr_factor: int = 4
    max_warps_per_sm: int = 48
    shared_banks: int = 32
    bank_bytes: int = 4               # Kepler: 8 (dual mode)
    shared_base_latency: float = 50.0 # §6.2 normal latencies
    measured_peak_gbps: float = 0.0   # Table 6 "maximum throughput"
    measured_shared_peak_gbps: float = 0.0  # Table 7 W'_SM

    @property
    def theoretical_gbps(self) -> float:
        return self.f_mem_mhz * 1e6 * (self.bus_width_bits / 8) * self.ddr_factor / 1e9

    @property
    def shared_theoretical_gbps(self) -> float:
        return self.f_core_ghz * self.bank_bytes * self.shared_banks


GTX560TI = GpuSpec("GTX560Ti", "fermi", sms=8, f_core_ghz=0.950, f_mem_mhz=1050,
                   bus_width_bits=256, max_warps_per_sm=48, bank_bytes=4,
                   shared_base_latency=50.0, measured_peak_gbps=109.38,
                   measured_shared_peak_gbps=35.70)
GTX780 = GpuSpec("GTX780", "kepler", sms=12, f_core_ghz=1.006, f_mem_mhz=1502,
                 bus_width_bits=384, max_warps_per_sm=64, bank_bytes=8,
                 shared_base_latency=47.0, measured_peak_gbps=215.92,
                 measured_shared_peak_gbps=96.58)
GTX980 = GpuSpec("GTX980", "maxwell", sms=16, f_core_ghz=1.279, f_mem_mhz=1753,
                 bus_width_bits=256, max_warps_per_sm=64, bank_bytes=4,
                 shared_base_latency=28.0, measured_peak_gbps=156.25,
                 measured_shared_peak_gbps=122.90)
# Held-out Volta generation (Jia et al. 2018): HBM2 — 4096-bit bus at DDR
# factor 2 (898 GB/s theoretical, ~88% protocol efficiency, better than the
# 70–81% the 2015 paper reports for GDDR5).
TESLAV100 = GpuSpec("TeslaV100", "volta", sms=80, f_core_ghz=1.380,
                    f_mem_mhz=877, bus_width_bits=4096, ddr_factor=2,
                    max_warps_per_sm=64, bank_bytes=4,
                    shared_base_latency=19.0, measured_peak_gbps=791.0,
                    measured_shared_peak_gbps=155.40)

GPU_SPECS = {s.name: s for s in (GTX560TI, GTX780, GTX980, TESLAV100)}

# Latency-spectrum constants (cycles).  Calibration anchors from the paper:
#  * 560Ti L1-cached L1TLB-miss penalty = 288 cycles; L2-cached = 27 (§5.2-3)
#  * GTX780 P2–P5 ≈ half the Fermi values (§5.2-4)
#  * GTX980 ≈ GTX780 on P1–P4; P5 ≈ 3.5× Kepler's, ≈ 2× Fermi's (§5.2-4)
#  * P6 exists only on Kepler/Maxwell; Maxwell's is much larger (§5.2-1)
FERMI_LATENCY = LatencyModel(l1_hit=96, l2_hit=371, dram=564,
                             l1tlb_miss=288, pagewalk=716)
KEPLER_LATENCY = LatencyModel(l1_hit=188, l2_hit=188, dram=301,
                              l1tlb_miss=27, pagewalk=364,
                              context_switch=2000)
MAXWELL_LATENCY = LatencyModel(l1_hit=82, l2_hit=214, dram=1052,
                               l1tlb_miss=24, pagewalk=360,
                               context_switch=5000)
# Volta (Jia et al. Table 3.1 anchors): L1 hit 28, L2 hit 193, HBM2 ~375;
# the virtually-addressed L1 makes P1=P2=P3 as on Maxwell; no page-table
# context-switch window is observable (P6 absent, as on Fermi).
VOLTA_LATENCY = LatencyModel(l1_hit=28, l2_hit=193, dram=375,
                             l1tlb_miss=35, pagewalk=400)


def make_hierarchy(device: str, l1_enabled: bool = True,
                   seed: int = 0) -> MemoryHierarchy:
    """Full global-memory hierarchy for one of the paper's devices."""
    rng = np.random.default_rng(seed)
    if device == "GTX560Ti":     # Fermi: L1+L2 data caches, both TLBs
        return MemoryHierarchy(
            name=device, latency=FERMI_LATENCY,
            l1=fermi_l1_data(rng) if l1_enabled else None,
            l2=l2_data(512 * KB, rng),
            l1tlb=l1_tlb(rng), l2tlb=l2_tlb(rng))
    if device == "GTX780":       # Kepler: global is L2-cached only (Table 3)
        return MemoryHierarchy(
            name=device, latency=KEPLER_LATENCY,
            l1=None,
            l2=l2_data(1536 * KB, rng),
            l1tlb=l1_tlb(rng), l2tlb=l2_tlb(rng),
            active_window_bytes=512 * MB)
    if device == "GTX980":       # Maxwell: unified L1 is virtually addressed
        return MemoryHierarchy(
            name=device, latency=MAXWELL_LATENCY,
            l1=maxwell_unified_l1(rng) if l1_enabled else None,
            l2=l2_data(2048 * KB, rng),
            l1tlb=l1_tlb(rng), l2tlb=l2_tlb(rng),
            l1_virtually_addressed=True,
            active_window_bytes=512 * MB)
    if device == "TeslaV100":    # Volta (held-out): Jia et al. 2018
        return MemoryHierarchy(
            name=device, latency=VOLTA_LATENCY,
            l1=volta_l1_data(rng) if l1_enabled else None,
            l2=l2_data(6 * MB, rng, prefetch=False),
            l1tlb=l1_tlb(rng), l2tlb=volta_l2_tlb(rng),
            l1_virtually_addressed=True)
    raise ValueError(f"unknown device {device!r}")


def expected_spectrum(device: str) -> dict[str, float]:
    """Published Fig-14 P1–P6 latencies, additive from the calibration
    constants (§5.2): this is the table the blind spectrum measurement is
    diffed against, derived from the latency model instead of hand-copied
    per device so a new hierarchy (Volta) gets its expectation for free."""
    h = make_hierarchy(device)
    lat = h.latency
    base = lat.l1_hit if h.l1 is not None else lat.l2_hit
    virt = h.l1 is not None and h.l1_virtually_addressed
    out = {
        "P1": base,
        "P2": base if virt else base + lat.l1tlb_miss,
        "P3": base if virt else base + lat.pagewalk,
        "P4": lat.dram,
        "P5": lat.dram + lat.pagewalk,
    }
    if h.active_window_bytes is not None:
        out["P6"] = out["P5"] + lat.context_switch
    return out


# Shared-memory bank-conflict latency (Table 8 — exact measured cycles;
# TeslaV100 row per Jia et al.: Volta keeps Maxwell's flattened slope).
BANK_CONFLICT_LATENCY = {
    # ways:        1    2    4    8    16    32
    "GTX980":   {1: 28, 2: 30, 4: 34, 8: 42, 16: 58, 32: 90},
    "GTX780":   {1: 47, 2: 82, 4: 96, 8: 158, 16: 257, 32: 484},
    "GTX560Ti": {1: 50, 2: 87, 4: 162, 8: 311, 16: 611, 32: 1209},
    "TeslaV100": {1: 19, 2: 21, 4: 25, 8: 33, 16: 49, 32: 81},
}

# ---------------------------------------------------------------------------
# TPU v5e target (roofline constants + VMEM geometry)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TpuSpec:
    name: str = "tpu_v5e"
    peak_bf16_flops: float = 197e12        # per chip
    hbm_bytes_per_s: float = 819e9         # per chip
    hbm_bytes: int = 16 * (1 << 30)        # 16 GiB per chip
    ici_bytes_per_s_per_link: float = 50e9 # ~50 GB/s/link
    ici_links: int = 4                     # 2D torus: 4 links/chip
    vmem_bytes: int = 128 * (1 << 20)      # per core
    sublanes: int = 8                      # native tile (8, 128)
    lanes: int = 128
    mxu_dim: int = 128
    hbm_latency_s: float = 1.0e-6          # Little's-law latency anchor

    @property
    def ici_bytes_per_s(self) -> float:
        return self.ici_bytes_per_s_per_link * self.ici_links


TPU_V5E = TpuSpec()

# ---------------------------------------------------------------------------
# Device registry (the hook `repro.bench` parameterizes experiments over)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceEntry:
    """One runnable measurement target.

    ``kind`` is ``"gpu-sim"`` for the paper's three GPUs (backed by the
    calibrated :mod:`repro.core.cachesim` models) or ``"tpu"`` for the real
    host target.  ``has_hierarchy`` marks devices accepted by
    :func:`make_hierarchy`.
    """

    name: str
    kind: str
    generation: str = ""
    spec: GpuSpec | TpuSpec | None = None
    has_hierarchy: bool = False


DEVICE_REGISTRY: dict[str, DeviceEntry] = {}


def register_device(entry: DeviceEntry) -> DeviceEntry:
    """Register a measurement target; duplicate names are an error."""
    if entry.name in DEVICE_REGISTRY:
        raise ValueError(f"device {entry.name!r} already registered")
    DEVICE_REGISTRY[entry.name] = entry
    return entry


def get_device(name: str) -> DeviceEntry:
    try:
        return DEVICE_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown device {name!r}; registered: {sorted(DEVICE_REGISTRY)}"
        ) from None


def list_devices(kind: str | None = None) -> list[DeviceEntry]:
    entries = DEVICE_REGISTRY.values()
    return [e for e in entries if kind is None or e.kind == kind]


for _spec in (GTX560TI, GTX780, GTX980, TESLAV100):
    register_device(DeviceEntry(_spec.name, "gpu-sim", _spec.generation,
                                _spec, has_hierarchy=True))
register_device(DeviceEntry(TPU_V5E.name, "tpu", "v5e", TPU_V5E))

# ---------------------------------------------------------------------------
# Simulated-cache registry (trace identities for the trace cache)
# ---------------------------------------------------------------------------

#: every fixed-geometry simulated structure, by its canonical name.  The
#: name doubles as the structure's ``trace_id`` in the content-addressed
#: trace cache and as the case label in benchmarks and differential tests.
SIM_CACHES = {
    "fermi_l1_data": fermi_l1_data,
    "kepler_texture_l1": kepler_texture_l1,
    "kepler_readonly": kepler_readonly,
    "maxwell_unified_l1": maxwell_unified_l1,
    "volta_l1_data": volta_l1_data,
    "l1_tlb": l1_tlb,
    "l2_tlb": l2_tlb,
    "volta_l2_tlb": volta_l2_tlb,
}


def sim_cache_backend(name: str, *, engine: str = "vector", **kw):
    """Trace backend for a registered simulated cache, wired into the trace
    cache under the structure's canonical name (the factories are
    deterministic, which is what makes the trace_id valid)."""
    from repro_torch.core.pchase import cache_backend   # local: keep layering flat
    try:
        factory = SIM_CACHES[name]
    except KeyError:
        raise KeyError(f"unknown simulated cache {name!r}; "
                       f"registered: {sorted(SIM_CACHES)}") from None
    return cache_backend(factory, engine=engine, trace_id=name, **kw)
