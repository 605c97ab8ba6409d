"""The dissect(backend) -> DeviceProfile pipeline.

A copy of ``repro/profile/pipeline.py`` for the port, whose batched
engine is ``engine="torch"``: its scan runs on ``device``, ``cuda``
unless the caller asks for ``cpu``.

For a simulated GPU device this runs the whole blind-recovery suite of
``repro_torch.core.inference`` — overflow size search, line/sector recovery,
set-structure staircase, replacement-policy reconstruction, set-bit
probing — against each of the device's registered trace backends, plus
the non-uniform-stride latency-spectrum chase (P1–P6), the Little's-law
occupancy sweep for sustained bandwidths, and the bank-conflict linear
fit.  Everything recovered that way is stamped ``measured``; anything the
suite does not (or, in ``quick`` mode, is told not to) recover falls back
to the published table and is stamped ``published``.

The TPU target has no simulated oracle, so its profile is the published
``TPU_V5E`` spec end to end.

Nothing here reads simulator internals: structure recovery consumes only
``(index, latency)`` traces through ``devices.sim_cache_backend``.  The
*published* columns legitimately do read the calibrated geometries — they
are the paper's tables, which is what the blind result is diffed against.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from repro_torch.core import bankconflict, devices, inference, littles_law, spectrum
from repro_torch.core.profile import (
    MEASURED, PUBLISHED, CacheProfile, DeviceProfile,
)

MB = 1 << 20
KB = 1 << 10


# ---------------------------------------------------------------------------
# per-device dissection plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StructureSpec:
    """How to blind-dissect one registered simulated structure."""

    sim_name: str
    n_max: int
    dissect_kw: dict = dataclasses.field(default_factory=dict)
    #: structures whose serial dissection dominates wall time.  Historical:
    #: quick mode used to skip these (published fallback rows); the batched
    #: engine made them cheap enough that every mode measures everything.
    #: The marker survives as documentation and for timing-table emphasis.
    slow: bool = False


_TLB_KW: dict[str, Any] = dict(
    stride_for_size=2 * MB, granularity=2 * MB, line_stride_bytes=2 * MB,
    max_line=8 * MB, structure_max_steps=80)

#: every structure the blind pipeline dissects, per device.  The L2 *data*
#: cache is deliberately absent: its fractional associativity (§4.6) is
#: published-only in this repo, so it exercises the fallback path.
DEVICE_STRUCTURES: dict[str, tuple[StructureSpec, ...]] = {
    "GTX560Ti": (
        StructureSpec("fermi_l1_data", 64 * KB,
                      dict(max_line=4096), slow=True),
        StructureSpec("l1_tlb", 512 * MB, dict(_TLB_KW)),
        StructureSpec("l2_tlb", 512 * MB, dict(_TLB_KW)),
    ),
    "GTX780": (
        StructureSpec("kepler_texture_l1", 64 * KB,
                      dict(max_line=4096), slow=True),
        StructureSpec("kepler_readonly", 64 * KB,
                      dict(max_line=4096), slow=True),
        StructureSpec("l1_tlb", 512 * MB, dict(_TLB_KW)),
        StructureSpec("l2_tlb", 512 * MB, dict(_TLB_KW)),
    ),
    "GTX980": (
        StructureSpec("maxwell_unified_l1", 128 * KB,
                      dict(max_line=4096), slow=True),
        StructureSpec("l1_tlb", 512 * MB, dict(_TLB_KW)),
        StructureSpec("l2_tlb", 512 * MB, dict(_TLB_KW)),
    ),
    "TeslaV100": (
        StructureSpec("volta_l1_data", 512 * KB,
                      dict(max_line=4096), slow=True),
        StructureSpec("l1_tlb", 512 * MB, dict(_TLB_KW)),
        StructureSpec("volta_l2_tlb", 1024 * MB,
                      dict(_TLB_KW, structure_max_steps=40,
                           set_bits_max_log2=26)),
    ),
}

#: paper-published set-index bit fields ([lo, hi) over byte addresses):
#: texture/unified L1 bits 7–8 (Fig 7), Fermi L1's split 9–13 field (§4.5),
#: Volta's page-grain modulo field.
PUBLISHED_SET_BITS: dict[str, tuple[int, int]] = {
    "kepler_texture_l1": (7, 9),
    "kepler_readonly": (7, 9),
    "maxwell_unified_l1": (7, 9),
    "volta_l1_data": (7, 9),
    "fermi_l1_data": (9, 14),
    "volta_l2_tlb": (21, 25),
}



# ---------------------------------------------------------------------------
# published profile (the fallback / diff reference)
# ---------------------------------------------------------------------------


def _published_cache(sim_name: str, role_name: str | None = None) -> CacheProfile:
    cache = devices.SIM_CACHES[sim_name]()
    g = cache.geom
    ways = list(g.way_counts)
    bits = PUBLISHED_SET_BITS.get(sim_name)
    pol = g.replacement
    return CacheProfile(
        name=role_name or sim_name,
        size_bytes=g.size_bytes,
        line_bytes=g.line_bytes,
        num_sets=g.num_sets,
        assoc=g.size_bytes / (g.line_bytes * g.num_sets),
        way_counts=ways,
        uniform_sets=len(set(ways)) <= 1,
        is_lru=pol.kind == "lru",
        way_probs=list(pol.way_probs) if pol.way_probs else None,
        set_bits=list(bits) if bits else None,
        provenance=PUBLISHED,
    )


def _published_l2_data(device: str) -> CacheProfile:
    """The permanent published-fallback row, derived from the calibrated
    hierarchy itself (Table 3 / Jia et al. capacities live in
    ``devices.make_hierarchy``, not re-stated here)."""
    g = devices.make_hierarchy(device).l2.geom
    ways = list(g.way_counts)
    return CacheProfile(
        name="l2_data", size_bytes=g.size_bytes, line_bytes=g.line_bytes,
        num_sets=g.num_sets,
        assoc=g.size_bytes / (g.line_bytes * g.num_sets),
        way_counts=ways, uniform_sets=len(set(ways)) <= 1,
        is_lru=g.replacement.kind == "lru", provenance=PUBLISHED)


def _published_bandwidth(spec: devices.GpuSpec) -> dict[str, float]:
    return {
        "global_gbps": spec.measured_peak_gbps,           # Table 6
        "global_theoretical_gbps": round(spec.theoretical_gbps, 2),
        "shared_gbps": spec.measured_shared_peak_gbps,    # Table 7 W'_SM
        "shared_theoretical_gbps": round(spec.shared_theoretical_gbps, 2),
    }


def _bank_table(device: str) -> dict[str, float]:
    return {str(w): float(c)
            for w, c in sorted(devices.BANK_CONFLICT_LATENCY[device].items())}


def published_profile(device: str) -> DeviceProfile:
    """Everything the paper (or the datasheet) states, provenance
    ``published`` throughout.  This is both the diff reference and the
    fallback the measured pipeline starts from."""
    entry = devices.get_device(device)
    if entry.kind == "tpu":
        spec = entry.spec
        spec_d = dataclasses.asdict(spec)
        spec_d.pop("name")
        return DeviceProfile(
            device=device, kind="tpu", generation=entry.generation,
            spec={k: float(v) for k, v in spec_d.items()},
            spec_provenance={k: PUBLISHED for k in spec_d},
        )
    gspec = entry.spec
    caches = {s.sim_name: _published_cache(s.sim_name)
              for s in DEVICE_STRUCTURES[device]}
    caches["l2_data"] = _published_l2_data(device)
    lat = {k: float(v) for k, v in devices.expected_spectrum(device).items()}
    bw = _published_bandwidth(gspec)
    base, slope = bankconflict.linear_fit(device)
    spec_d = dataclasses.asdict(gspec)
    spec_d.pop("name")
    return DeviceProfile(
        device=device, kind=entry.kind, generation=entry.generation,
        caches=caches,
        latency=lat,
        latency_provenance={k: PUBLISHED for k in lat},
        bandwidth=bw,
        bandwidth_provenance={k: PUBLISHED for k in bw},
        bank_conflict={"generation": gspec.generation,
                       "base_cycles": round(base, 2),
                       "slope_cycles_per_way": round(slope, 2),
                       "table": _bank_table(device),
                       "provenance": PUBLISHED},
        spec={k: float(v) for k, v in spec_d.items()
              if isinstance(v, (int, float))},
        spec_provenance={k: PUBLISHED for k in spec_d
                         if isinstance(spec_d[k], (int, float))},
    )


# ---------------------------------------------------------------------------
# measured pipeline
# ---------------------------------------------------------------------------


#: the trace-simulation engines the port's pipeline runs
ENGINES = ("vector", "reference", "torch")


def resolve_engine(engine: str | None = "auto") -> str:
    """Concrete engine name for a dissection request.

    ``"auto"`` picks the port's batched torch engine, whose scan runs on
    the card unless the caller names ``device="cpu"``; the names are
    ``"vector"``, ``"reference"`` and ``"torch"``."""
    if engine in (None, "auto"):
        return "torch"
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; the port runs "
                         f"{', '.join(ENGINES)}")
    return engine


def _measured_cache(spec: StructureSpec, *, engine: str = "vector",
                    device: str | torch.device | None = None
                    ) -> CacheProfile:
    # the registered factories are deterministic (fixed seed) — that is
    # what makes the shared trace_id (= sim_name) valid across runs
    kw = {"device": device} if engine == "torch" else {}
    be = devices.sim_cache_backend(spec.sim_name, engine=engine, **kw)
    params = inference.dissect(be, n_max=spec.n_max, **spec.dissect_kw)
    way_probs = params.way_probs
    if not params.is_lru:
        # refine the Fig-11 probability estimate: the dissect-default 60
        # passes bound the chain sample too loosely for a 5% diff
        rep = inference.detect_replacement(
            be, params.size_bytes, params.line_bytes, passes=600)
        way_probs = rep.way_probs or way_probs
    return CacheProfile(
        name=spec.sim_name,
        size_bytes=params.size_bytes,
        line_bytes=params.line_bytes,
        num_sets=params.num_sets,
        assoc=params.assoc,
        way_counts=list(params.way_counts),
        uniform_sets=params.uniform_sets,
        is_lru=params.is_lru,
        way_probs=list(way_probs) if way_probs else None,
        set_bits=list(params.set_bits) if params.set_bits else None,
        provenance=MEASURED,
    )


def dissect_structures(target: str, *, engine: str = "auto",
                       device: str | torch.device | None = None,
                       ) -> tuple[dict[str, CacheProfile], dict[str, float]]:
    """Blind structure search of the registered GPU ``target`` only:
    ``(caches, per-stage timings)``.

    The timed unit that ``chip_smoke.py`` races across engines;
    :func:`dissect_device` composes it with the spectrum, bandwidth and
    bank-conflict stages. ``device`` is where the torch engine's scan
    runs (``cuda`` unless named); the numpy engines ignore it."""
    engine = resolve_engine(engine)
    caches: dict[str, CacheProfile] = {}
    timings: dict[str, float] = {}
    for sspec in DEVICE_STRUCTURES[target]:
        t0 = time.perf_counter()
        caches[sspec.sim_name] = _measured_cache(sspec, engine=engine,
                                                 device=device)
        timings[sspec.sim_name] = round(time.perf_counter() - t0, 4)
    return caches, timings


def dissect_device(target: str, *, quick: bool = False, seed: int = 0,
                   engine: str = "auto",
                   device: str | torch.device | None = None,
                   ) -> DeviceProfile:
    """Run the blind-recovery suite against one registered device,
    ``target`` (the reference's first argument, renamed here so that
    ``device`` names the torch device, as in the rest of the port).

    Starts from :func:`published_profile` and overwrites every field the
    suite measures, flipping its provenance.  ``engine`` selects the
    trace-simulation core (``"auto"`` → the batched torch engine, whose
    scan runs on ``device``: ``cuda`` unless named).
    Since the batched engine made the slow data-cache stages cheap,
    ``quick`` mode measures every structure too — the flag survives in
    the artifact as a record of which contract produced it.  Per-stage
    wall time lands in ``profile.timings``.
    """
    entry = devices.get_device(target)
    prof = published_profile(target)
    prof.seed = seed
    prof.quick = quick
    if entry.kind == "tpu":
        # No oracle to dissect blind; the published spec IS the profile.
        # (prof.engine keeps its "vector" default: no engine ran.)
        return prof

    from repro_torch.core.cachesim import ENGINE_VERSION, TORCH_ENGINE_VERSION
    engine = resolve_engine(engine)
    prof.engine = engine
    prof.engine_version = (TORCH_ENGINE_VERSION if engine == "torch"
                           else ENGINE_VERSION)

    caches, timings = dissect_structures(target, engine=engine,
                                         device=device)
    prof.caches.update(caches)

    t0 = time.perf_counter()
    measured_lat = spectrum.measure_spectrum(
        lambda: devices.make_hierarchy(target, seed=seed))
    prof.latency = {k: float(v) for k, v in measured_lat.items()}
    prof.latency_provenance = {k: MEASURED for k in prof.latency}
    timings["spectrum"] = round(time.perf_counter() - t0, 4)

    t0 = time.perf_counter()
    gspec = entry.spec
    _, g_bw = littles_law.best_occupancy(gspec, "global")
    _, s_bw = littles_law.best_occupancy(gspec, "shared")
    prof.bandwidth["global_gbps"] = round(g_bw, 2)
    prof.bandwidth["shared_gbps"] = round(s_bw, 2)
    prof.bandwidth_provenance["global_gbps"] = MEASURED
    prof.bandwidth_provenance["shared_gbps"] = MEASURED
    timings["bandwidth"] = round(time.perf_counter() - t0, 4)

    t0 = time.perf_counter()
    base, slope = bankconflict.linear_fit(target)
    prof.bank_conflict.update({
        "base_cycles": round(base, 2),
        "slope_cycles_per_way": round(slope, 2),
        "table": {str(w): float(bankconflict.latency_for_ways(target, w))
                  for w in (1, 2, 4, 8, 16, 32)},
        "provenance": MEASURED,
    })
    timings["bank_conflict"] = round(time.perf_counter() - t0, 4)

    timings["total"] = round(sum(timings.values()), 4)
    prof.timings = timings
    return prof
