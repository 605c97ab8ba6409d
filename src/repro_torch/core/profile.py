"""Calibrated device profiles: the dissect→deploy seam.

A copy of ``repro/core/profile.py`` for the port: numpy and the
standard library only, nothing of ``repro``.

The paper's thesis is that software optimization should consume *measured*
memory-hierarchy parameters, not datasheet numbers.  This module is where
that lands in code: a :class:`DeviceProfile` holds every parameter the
dissection suite recovers — cache/TLB geometries, the P1–P6 latency
spectrum, bandwidths, the bank-conflict model, and the TPU spec the
kernel/serving consumers price against — and every field carries
**provenance**: ``"measured"`` when the blind pipeline
(:mod:`repro.profile.pipeline`) derived it from traces, ``"published"``
when it fell back to the datasheet / paper table.

Consumers (``costmodel``, ``core.autotune``, ``core.littles_law``,
``core.roofline``, ``serve.paging``) no longer each default to the
module-level ``TPU_V5E`` constant independently; they resolve through
:func:`resolve_spec`, which honors one process-wide active profile (see
:func:`set_default_profile` / :func:`use_profile`) and warns — once per
plan — when a single plan is priced against two different profiles.

Profiles serialize to the versioned ``repro.profile/v1`` JSON artifact
(persisted under ``experiments/profiles/`` by :mod:`repro.profile.store`)
stamped with the trace-engine version and a fingerprint of the device
registry, so CI can fail on stale artifacts.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import json
import warnings
from typing import Any

from repro_torch.core.cachesim import (
    ENGINE_VERSION, JAX_ENGINE_VERSION, TORCH_ENGINE_VERSION,
)
from repro_torch.core import devices as _devices
from repro_torch.core.devices import TPU_V5E, TpuSpec

PROFILE_SCHEMA = "repro.profile/v1"

MEASURED = "measured"
PUBLISHED = "published"
_PROVENANCES = (MEASURED, PUBLISHED)


class SpecMixWarning(UserWarning):
    """A single plan was priced against two different device profiles."""


#: fp32 CUDA cores per SM by generation — the only datasheet number the
#: GPU serving-spec view needs that the dissection suite cannot measure
#: (FLOP peaks are not a memory-hierarchy observable)
_GPU_CORES_PER_SM = {"fermi": 32, "kepler": 192, "maxwell": 128,
                     "volta": 64}


# ---------------------------------------------------------------------------
# dataclasses
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CacheProfile:
    """One dissected (or published) cache/TLB structure."""

    name: str
    size_bytes: int
    line_bytes: int
    num_sets: int
    assoc: float
    way_counts: list[int]
    uniform_sets: bool
    is_lru: bool
    way_probs: list[float] | None = None
    set_bits: list[int] | None = None        # [lo, hi) address-bit field
    provenance: str = PUBLISHED

    def __post_init__(self) -> None:
        if self.provenance not in _PROVENANCES:
            raise ValueError(f"bad provenance {self.provenance!r}")

    def summary(self) -> str:
        pol = "LRU" if self.is_lru else "non-LRU"
        bits = (f" bits[{self.set_bits[0]},{self.set_bits[1]})"
                if self.set_bits else "")
        return (f"C={self.size_bytes}B b={self.line_bytes}B "
                f"T={self.num_sets} a={self.assoc:g}{bits} {pol} "
                f"[{self.provenance}]")


@dataclasses.dataclass
class DeviceProfile:
    """Everything the dissection suite knows about one device.

    ``caches`` is keyed by the canonical simulated-structure name (the
    ``SIM_CACHES`` key / trace id) or a published-only role name like
    ``"l2_data"``.  ``latency`` maps the paper's P1–P6 pattern classes to
    cycles; ``spec`` carries the TPU-shaped consumer numbers (peak FLOP/s,
    HBM bandwidth/latency, VMEM geometry).  Every section has a sibling
    ``*_provenance`` map with one entry per field.
    """

    device: str
    kind: str                                   # "gpu-sim" | "tpu"
    generation: str = ""
    engine: str = "vector"                      # engine that dissected it
    engine_version: str = ENGINE_VERSION
    registry_hash: str = ""
    seed: int = 0
    quick: bool = False
    #: wall-clock seconds per dissection stage (optional; empty for
    #: published-only / TPU profiles)
    timings: dict[str, float] = dataclasses.field(default_factory=dict)
    caches: dict[str, CacheProfile] = dataclasses.field(default_factory=dict)
    latency: dict[str, float] = dataclasses.field(default_factory=dict)
    latency_provenance: dict[str, str] = dataclasses.field(default_factory=dict)
    bandwidth: dict[str, float] = dataclasses.field(default_factory=dict)
    bandwidth_provenance: dict[str, str] = dataclasses.field(default_factory=dict)
    bank_conflict: dict[str, Any] = dataclasses.field(default_factory=dict)
    spec: dict[str, float] = dataclasses.field(default_factory=dict)
    spec_provenance: dict[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.registry_hash:
            self.registry_hash = registry_fingerprint()

    # -- consumer view -----------------------------------------------------

    def tpu_spec(self) -> TpuSpec:
        """The spec object every consumer prices against.

        Only meaningful for TPU-family profiles; a GPU profile feeds the
        GPU-side models (littles_law occupancy, bankconflict) instead.
        """
        if self.kind != "tpu":
            raise ValueError(
                f"profile {self.device!r} is kind={self.kind!r}; only tpu "
                "profiles provide a TpuSpec consumer view")
        fields = {f.name for f in dataclasses.fields(TpuSpec)} - {"name"}
        kw = {}
        for k, v in self.spec.items():
            if k not in fields:
                continue
            # JSON stores every number as float; restore int-ness (judged
            # by the default instance's value, which is robust to how the
            # field annotation is spelled) so tile arithmetic stays integral
            kw[k] = int(v) if isinstance(getattr(TPU_V5E, k), int) else float(v)
        return TpuSpec(name=self.device, **kw)

    def serving_spec(self) -> TpuSpec:
        """A TpuSpec-shaped *pricing* view for any profile kind.

        The fleet router (``repro.serve.fleet``) prices every replica with
        the same ``CellCost`` machinery, so a GPU profile must present the
        consumer fields a :class:`TpuSpec` carries.  For ``kind="tpu"``
        this is :meth:`tpu_spec`.  For a dissected GPU the fields come
        from the profile's own measurements wherever one exists:

        * ``hbm_bytes_per_s`` — the sustained global bandwidth the
          Little's-law occupancy sweep found (``bandwidth/global_gbps``,
          Table 6 fallback);
        * ``hbm_latency_s`` — the measured P4 (DRAM) latency of the
          spectrum chase, converted from cycles at the core clock: the
          paper's latency × bandwidth product, per device;
        * ``peak_bf16_flops`` — napkin FMA peak, SMs × cores/SM × 2 ×
          f_core (GPUs here have no bf16 units; this is the fp32 peak the
          compute term is priced against);
        * ``lanes`` — the shared-memory bank count, so the bank-conflict
          row model in ``serve.paging`` sizes page rows to whole bank
          rows (32 banks × 4 B = one 128 B coalesced line).

        Remaining fields (VMEM geometry, ICI) keep the TpuSpec defaults;
        the serving consumers never read them for a single-chip plan.
        """
        if self.kind == "tpu":
            return self.tpu_spec()
        # fail CLOSED on anything the pricing needs: a silently defaulted
        # clock or SM count would misprice fleet routing by orders of
        # magnitude, which is worse than refusing the profile
        missing = [k for k in ("f_core_ghz", "sms") if k not in self.spec]
        if "global_gbps" not in self.bandwidth:
            missing.append("bandwidth/global_gbps")
        if not self.latency.get("P4"):
            missing.append("latency/P4")
        if missing:
            raise ValueError(
                f"profile {self.device!r} cannot price serving: missing "
                f"{missing}")
        if self.generation not in _GPU_CORES_PER_SM:
            raise ValueError(
                f"profile {self.device!r}: unknown generation "
                f"{self.generation!r}; extend _GPU_CORES_PER_SM to price "
                "its FLOP peak")
        f_core_hz = float(self.spec["f_core_ghz"]) * 1e9
        cores = _GPU_CORES_PER_SM[self.generation]
        return TpuSpec(
            name=self.device,
            peak_bf16_flops=float(self.spec["sms"]) * cores * 2.0
            * f_core_hz,
            hbm_bytes_per_s=float(self.bandwidth["global_gbps"]) * 1e9,
            hbm_latency_s=float(self.latency["P4"]) / f_core_hz,
            lanes=int(self.spec.get("shared_banks", TPU_V5E.lanes)),
        )

    def provenance_counts(self) -> dict[str, int]:
        counts = {MEASURED: 0, PUBLISHED: 0}
        for c in self.caches.values():
            counts[c.provenance] += 1
        for src in (self.latency_provenance, self.bandwidth_provenance,
                    self.spec_provenance):
            for p in src.values():
                if p in counts:       # illegal values are store.validate's
                    counts[p] += 1    # job; a summary must never raise
        bc = self.bank_conflict.get("provenance")
        if bc in counts:
            counts[bc] += 1
        return counts

    def is_stale(self) -> list[str]:
        """Reasons this profile can no longer be trusted (empty = fresh).

        The expected engine version depends on which engine dissected the
        profile: numpy-engine profiles track ``ENGINE_VERSION``, batched
        profiles ``JAX_ENGINE_VERSION``, the port's torch-engine profiles
        ``TORCH_ENGINE_VERSION``.  An unknown engine name is itself
        a staleness reason (fail closed)."""
        problems = []
        expected = {"vector": ENGINE_VERSION,
                    "reference": ENGINE_VERSION,
                    "jax": JAX_ENGINE_VERSION,
                    "torch": TORCH_ENGINE_VERSION}.get(self.engine)
        if expected is None:
            problems.append(f"unknown dissection engine {self.engine!r}")
        elif self.engine_version != expected:
            problems.append(
                f"engine version {self.engine_version!r} != current "
                f"{expected!r} for engine {self.engine!r}")
        current = registry_fingerprint()
        if self.registry_hash != current:
            problems.append(
                f"device-registry hash {self.registry_hash!r} != current "
                f"{current!r}")
        return problems

    # -- serialization -----------------------------------------------------

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["caches"] = {k: dataclasses.asdict(v)
                       for k, v in self.caches.items()}
        d["schema"] = PROFILE_SCHEMA
        return d

    @classmethod
    def from_json(cls, payload: dict) -> "DeviceProfile":
        schema = payload.get("schema")
        if schema != PROFILE_SCHEMA:
            raise ValueError(
                f"not a {PROFILE_SCHEMA} artifact (schema={schema!r})")
        d = {k: v for k, v in payload.items() if k != "schema"}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown profile fields: {sorted(unknown)}")
        d["caches"] = {k: CacheProfile(**v)
                       for k, v in d.get("caches", {}).items()}
        for sec in ("latency_provenance", "bandwidth_provenance",
                    "spec_provenance"):
            bad = {k: v for k, v in d.get(sec, {}).items()
                   if v not in _PROVENANCES}
            if bad:
                raise ValueError(f"{sec}: illegal provenance {bad}")
        return cls(**d)

    def summary(self) -> str:
        pc = self.provenance_counts()
        return (f"{self.device} [{self.kind}/{self.generation}] "
                f"{len(self.caches)} structures, "
                f"{len(self.latency)} latency classes; "
                f"{pc[MEASURED]} measured / {pc[PUBLISHED]} published fields")


# ---------------------------------------------------------------------------
# registry fingerprint (staleness anchor)
# ---------------------------------------------------------------------------


def _mapping_probe(cache) -> list[int]:
    """Deterministic observable of the (unhashable) set-map closure."""
    m = cache.geom.mapper()
    lb = cache.geom.line_bytes
    return [int(m(i * lb)) for i in range(64)]


def _geom_descriptor(cache) -> dict | None:
    """Stable descriptor of one cache level (None level stays None)."""
    if cache is None:
        return None
    g = cache.geom
    return {
        "line": g.line_bytes,
        "ways": list(g.way_counts),
        "policy": g.replacement.kind,
        "probs": list(g.replacement.way_probs or ()),
        "prefetch": g.prefetch_lines,
        "map": _mapping_probe(cache),
    }


@functools.lru_cache(maxsize=1)
def registry_fingerprint() -> str:
    """Hash of everything a profile is dissected *from*: simulated cache
    geometries (including their set mappings, probed), full per-device
    hierarchy compositions, latency calibrations, GPU/TPU published
    specs, the bank-conflict table and the trace-engine version.  Any
    change here must invalidate committed profile artifacts.  Pure in the
    module constants, so memoized (building four hierarchies plus the
    mapping probes costs ~15 ms per call)."""
    desc: dict[str, Any] = {"engine": ENGINE_VERSION}
    for name in sorted(_devices.SIM_CACHES):
        desc[f"cache/{name}"] = _geom_descriptor(_devices.SIM_CACHES[name]())
    for dev, spec in sorted(_devices.GPU_SPECS.items()):
        desc[f"gpu/{dev}"] = dataclasses.asdict(spec)
        desc[f"spectrum/{dev}"] = _devices.expected_spectrum(dev)
        # the full hierarchy composition — covers the parameterized L2
        # data cache (size/sets/prefetch, absent from SIM_CACHES), page
        # size, L1 addressing mode and the active window, all of which
        # the spectrum measurements depend on
        h = _devices.make_hierarchy(dev)
        desc[f"hierarchy/{dev}"] = {
            "l1": _geom_descriptor(h.l1),
            "l2": _geom_descriptor(h.l2),
            "l1tlb": _geom_descriptor(h.l1tlb),
            "l2tlb": _geom_descriptor(h.l2tlb),
            "page_bytes": h.page_bytes,
            "l1_virtual": h.l1_virtually_addressed,
            "window": h.active_window_bytes,
        }
    desc["tpu"] = dataclasses.asdict(TPU_V5E)
    desc["bank_conflict"] = {
        d: {str(k): v for k, v in t.items()}
        for d, t in sorted(_devices.BANK_CONFLICT_LATENCY.items())}
    blob = json.dumps(desc, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


# ---------------------------------------------------------------------------
# active-profile resolution (the default-spec-trap fix)
# ---------------------------------------------------------------------------

_ACTIVE: DeviceProfile | TpuSpec | None = None


def set_default_profile(profile: DeviceProfile | TpuSpec | None):
    """Install the process-wide default consumers resolve to; returns the
    previous default so callers can restore it."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, profile
    return prev


def get_default_profile() -> DeviceProfile | TpuSpec | None:
    return _ACTIVE


@contextlib.contextmanager
def use_profile(profile: DeviceProfile | TpuSpec | None):
    """Scoped :func:`set_default_profile` (tests, launchers)."""
    prev = set_default_profile(profile)
    try:
        yield profile
    finally:
        set_default_profile(prev)


def resolve_spec(spec: "DeviceProfile | TpuSpec | None" = None) -> TpuSpec:
    """One resolution path for every consumer.

    ``None`` resolves to the active profile (or the published ``TPU_V5E``
    fallback); a :class:`DeviceProfile` resolves to its consumer spec view;
    a :class:`TpuSpec` passes through.  All former ``spec=TPU_V5E``
    defaults route here, so a launcher-installed profile reaches every
    downstream decision without threading a parameter through each call.
    """
    if spec is None:
        spec = _ACTIVE if _ACTIVE is not None else TPU_V5E
    if isinstance(spec, DeviceProfile):
        return spec.tpu_spec()
    return spec


_MIX_WARNED: set[tuple[str, str, str]] = set()


def warn_spec_mix(plan: str, first: TpuSpec, now: TpuSpec) -> None:
    """Warn (once per plan × pair) that one plan mixed two profiles.

    Names the *fields* that differ: in the primary trap the two specs
    share a name (a dissected ``tpu_v5e`` profile vs the built-in
    constant), so the names alone would make the warning unactionable.
    """
    key = (plan, first.name, now.name)
    if key in _MIX_WARNED:
        return
    _MIX_WARNED.add(key)
    diffs = [f"{f.name}: {getattr(first, f.name):g} -> "
             f"{getattr(now, f.name):g}"
             for f in dataclasses.fields(TpuSpec)
             if f.name != "name" and getattr(first, f.name) != getattr(now, f.name)]
    warnings.warn(
        f"plan {plan!r} was priced with profile {first.name!r} but is now "
        f"being evaluated with {now.name!r} ({'; '.join(diffs) or 'same values'}); "
        "mixing profiles across one plan silently invalidates its "
        "predictions",
        SpecMixWarning, stacklevel=3)
