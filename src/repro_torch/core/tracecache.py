"""Content-addressed P-chase trace cache.

A copy of ``repro/core/tracecache.py`` for the port, with a root and
environment variables of its own: the default root is
``build/repro_torch/traces`` at the repository root, configured by
``REPRO_TORCH_TRACE_CACHE_DIR`` (and capped by
``REPRO_TORCH_TRACE_CACHE_MAX_MB``). It never reads the JAX package's
variables nor writes its ``experiments/traces/``. The torch engine's
traces are keyed under
:data:`~repro_torch.core.cachesim.TORCH_ENGINE_VERSION`, so they never
serve the numpy engines and are never served by them.

Simulated traces are pure functions of (probed structure, chase config,
seed, engine revision) — yet before this cache every sweep re-simulated
identical streams: ``inference.dissect`` replays the same overflow traces
the spectrum/TLB/classic experiments already produced, and every
bench run regenerates all of them from scratch.  This module
gives each backend a consult-before-simulate store:

* **Key** — SHA-256 over the canonical JSON of ``(trace_id, PChaseConfig
  fields, seed, ENGINE_VERSION, backend params, digest of any explicit
  index stream)``.  ``trace_id`` names the probed structure (a registered
  device / cache factory label); callers must only pass one for
  deterministic backends.
* **Layout** — ``<root>/<engine tag>/<hh>/<key>.npz`` (two-level fan-out),
  one npz per trace.  Payloads are stored compactly: hit/miss masks as
  packed bits, two-valued latency streams as (bitmask, lo, hi), and the
  index stream of a uniform chase omitted entirely (the caller rebuilds it
  from the config at load).  Bulky debug-only meta (``replaced_ways``) is
  not persisted — reloaded traces carry the measurement contract, not
  simulator internals.  The engine tag directory means a bumped
  :data:`repro_torch.core.cachesim.ENGINE_VERSION` abandons stale traces
  wholesale.
* **Eviction** — size-capped (``REPRO_TORCH_TRACE_CACHE_MAX_MB``, default 512):
  on insert, oldest-mtime files are pruned until the root fits under the
  cap.  Reads bump mtime, so the policy is LRU-by-file.
* **Concurrency** — writes go through a temp file + ``os.replace`` so
  parallel bench workers never observe torn traces; a corrupt/unreadable
  entry is treated as a miss and deleted.

The default process-wide cache is configured by :func:`configure` or the
``REPRO_TORCH_TRACE_CACHE_DIR`` environment variable.  When unconfigured, every
lookup misses and nothing is written — unit tests stay hermetic.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import Any

import numpy as np

from repro_torch.core.cachesim import ENGINE_VERSION
from repro_torch.core.trace import PChaseConfig, PChaseTrace

#: the port's own trace root, under the repository's ignored ``build/``
DEFAULT_ROOT = str(Path(__file__).resolve().parents[3] / "build"
                   / "repro_torch" / "traces")
DEFAULT_MAX_MB = 512

# meta fields that round-trip through the npz payload
_BITMASK_META = ("true_miss",)
_SCALAR_META = ("miss_threshold", "steady_state_tiled", "per_access_ns")


def _pack_mask(mask: np.ndarray) -> np.ndarray:
    return np.packbits(np.asarray(mask, dtype=bool))


def _unpack_mask(bits: np.ndarray, n: int) -> np.ndarray:
    return np.unpackbits(bits, count=n).astype(bool)


def _canonical(parts: dict[str, Any]) -> str:
    return json.dumps(parts, sort_keys=True, separators=(",", ":"),
                      default=str)


def indices_digest(indices: np.ndarray) -> str:
    """Stable digest of an explicit index stream (custom-init chases)."""
    arr = np.ascontiguousarray(indices, dtype=np.int64)
    return hashlib.sha256(arr.tobytes()).hexdigest()[:32]


class TraceCache:
    """One cache root.  All operations are best-effort: I/O errors degrade
    to cache misses, never to harness failures."""

    #: bytes written between eviction scans (a full-tree walk per put would
    #: be quadratic in cache size)
    _EVICT_EVERY = 32 << 20

    def __init__(self, root: str, max_bytes: int = DEFAULT_MAX_MB << 20):
        self.root = root
        self.max_bytes = max_bytes
        self.hits = 0
        self.misses = 0
        self._written_since_evict = 0

    # -- keys ---------------------------------------------------------------

    def key(self, trace_id: str, config: PChaseConfig, *, seed: int = 0,
            extra: dict[str, Any] | None = None,
            indices: np.ndarray | None = None,
            engine_version: str | None = None) -> str:
        """Content key for one trace.  ``engine_version`` names the engine
        revision the trace was (or would be) produced under — the numpy
        :data:`~repro_torch.core.cachesim.ENGINE_VERSION` by default, the
        torch :data:`~repro_torch.core.cachesim.TORCH_ENGINE_VERSION` for
        batched traces.  The version is hashed into the key AND prefixes the
        storage path, so a torch-produced entry can never be served to the
        numpy engines (whose stochastic-policy streams differ draw for
        draw) or vice versa, and bumping either version abandons that
        engine's tag directory wholesale."""
        ev = engine_version or ENGINE_VERSION
        parts: dict[str, Any] = {
            "trace_id": trace_id,
            "engine": ev,
            "seed": seed,
            "config": [config.array_bytes, config.stride_bytes,
                       config.iterations, config.elem_bytes,
                       config.warmup_passes],
        }
        if extra:
            parts["extra"] = extra
        if indices is not None:
            parts["indices"] = indices_digest(indices)
        digest = hashlib.sha256(_canonical(parts).encode()).hexdigest()
        # composite key: "<engine tag>/<sha256>", e.g. "trace-engine-2/ab..."
        return f"{ev.replace('/', '-')}/{digest}"

    def _path(self, key: str) -> str:
        tag, _, digest = key.rpartition("/")
        tag = tag or ENGINE_VERSION.replace("/", "-")
        return os.path.join(self.root, tag, digest[:2], digest + ".npz")

    # -- get / put ----------------------------------------------------------

    def get(self, key: str, config: PChaseConfig,
            rebuild_indices: np.ndarray | None = None) -> PChaseTrace | None:
        """Load a trace.  ``rebuild_indices`` restores the index stream for
        entries stored without one (uniform chases — the caller rebuilds
        the stream from the config for free)."""
        path = self._path(key)
        try:
            with np.load(path, allow_pickle=False) as z:
                n = int(z["n"])
                if "indices" in z.files:
                    indices = z["indices"].astype(np.int64)
                elif rebuild_indices is not None:
                    indices = np.asarray(rebuild_indices, dtype=np.int64)
                else:
                    raise ValueError("trace stored without indices")
                if "lat_mask" in z.files:   # two-valued latency stream
                    lo, hi = z["lat_values"]
                    latencies = np.where(_unpack_mask(z["lat_mask"], n),
                                         hi, lo).astype(np.float64)
                else:
                    latencies = z["latencies"]
                meta: dict[str, Any] = {}
                for name in _BITMASK_META:
                    if f"{name}_bits" in z.files:
                        meta[name] = _unpack_mask(z[f"{name}_bits"], n)
                if "patterns" in z.files:
                    meta["patterns"] = [p if p != "" else None
                                        for p in z["patterns"].tolist()]
                if "scalar_meta" in z.files:
                    meta.update(json.loads(str(z["scalar_meta"])))
                trace = PChaseTrace(config, indices, latencies, meta=meta)
        except FileNotFoundError:
            self.misses += 1
            return None
        except Exception:                      # torn/stale file: drop it
            self.misses += 1
            try:
                os.unlink(path)
            except OSError:
                pass
            return None
        self.hits += 1
        try:
            os.utime(path)                     # LRU bump
        except OSError:
            pass
        return trace

    def put(self, key: str, trace: PChaseTrace,
            omit_indices: bool = False) -> None:
        """Store a trace.  ``omit_indices`` skips the index stream for
        uniform chases (rebuilt at load from the config)."""
        n = len(trace.latencies)
        payload: dict[str, Any] = {"n": np.int64(n)}
        if not omit_indices:
            idx = trace.indices
            if idx.size and 0 <= idx.min() and idx.max() < 2 ** 31:
                idx = idx.astype(np.int32)
            payload["indices"] = idx
        lat = trace.latencies
        vals = np.unique(lat)
        if vals.size == 2:
            payload["lat_mask"] = _pack_mask(lat == vals[1])
            payload["lat_values"] = vals
        elif vals.size == 1:
            payload["lat_mask"] = _pack_mask(np.zeros(n, dtype=bool))
            payload["lat_values"] = np.array([vals[0], vals[0]])
        else:
            payload["latencies"] = lat
        scalar: dict[str, Any] = {}
        for name, value in trace.meta.items():
            if name in _BITMASK_META:
                payload[f"{name}_bits"] = _pack_mask(value)
            elif name == "patterns":
                payload[name] = np.asarray(
                    [p if p is not None else "" for p in value])
            elif name in _SCALAR_META:
                scalar[name] = float(value)
            # other meta (e.g. replaced_ways — debug internals) is not
            # persisted; the measurement contract round-trips in full
        if scalar:
            payload["scalar_meta"] = np.asarray(json.dumps(scalar))
        try:
            os.makedirs(os.path.dirname(path := self._path(key)),
                        exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                       suffix=".tmp")
            with os.fdopen(fd, "wb") as fh:
                # uncompressed: traces are compact already and zlib costs
                # more than the simulation it would save
                np.savez(fh, **payload)
            os.replace(tmp, path)
            self._written_since_evict += os.path.getsize(path)
        except OSError:
            return
        if self._written_since_evict >= self._EVICT_EVERY:
            self._written_since_evict = 0
            self._evict()

    # -- eviction -----------------------------------------------------------

    def _entries(self) -> list[tuple[float, int, str]]:
        out = []
        for dirpath, _, files in os.walk(self.root):
            for f in files:
                if not f.endswith(".npz"):
                    continue
                p = os.path.join(dirpath, f)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                out.append((st.st_mtime, st.st_size, p))
        return out

    def _evict(self) -> None:
        entries = self._entries()
        total = sum(size for _, size, _ in entries)
        if total <= self.max_bytes:
            return
        for _, size, path in sorted(entries):          # oldest mtime first
            try:
                os.unlink(path)
            except OSError:
                continue
            total -= size
            if total <= self.max_bytes:
                break


# ---------------------------------------------------------------------------
# Process-wide default (what the backends consult)
# ---------------------------------------------------------------------------

_default: TraceCache | None = None
_configured = False


def configure(root: str | None = DEFAULT_ROOT, *,
              max_mb: int | None = None) -> TraceCache | None:
    """Install (or, with ``root=None``, remove) the process default."""
    global _default, _configured
    _configured = True
    if root is None:
        _default = None
    else:
        if max_mb is None:
            max_mb = int(os.environ.get("REPRO_TORCH_TRACE_CACHE_MAX_MB",
                                        DEFAULT_MAX_MB))
        _default = TraceCache(root, max_bytes=max_mb << 20)
    return _default


def default_cache() -> TraceCache | None:
    """The process-wide cache, or None when disabled (the default)."""
    global _configured
    if not _configured:
        env = os.environ.get("REPRO_TORCH_TRACE_CACHE_DIR")
        if env:
            configure(env)
        else:
            _configured = True
    return _default


@contextlib.contextmanager
def disabled():
    """Temporarily turn the process cache off — the dissect-speed
    benchmark uses this so engine timings race raw simulation, not a
    warm trace store."""
    global _default, _configured
    saved = (_default, _configured)
    _default, _configured = None, True
    try:
        yield
    finally:
        _default, _configured = saved
