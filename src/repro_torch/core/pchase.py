"""P-chase microbenchmark engines (classic + fine-grained), for the port.

A copy of ``repro/core/pchase.py``: the :class:`TraceBackend` contract,
the index-sequence constructors, the simulator backends and the paper's
three measurement methods.

* ``saavedra1992`` — average latency vs stride, N fixed (Fig 4).
* ``wong2010`` — average latency vs array size, stride fixed (Fig 5).
* ``fine_grained`` — the paper's contribution (§4.2, Listing 3): record the
  latency *and* the index of every single access.

All methods are backend-generic: a backend is any callable
``(PChaseConfig, indices) -> PChaseTrace``. The backends here drive the
cache simulator; ``repro_torch.kernels.pchase.kernel_trace_backend``
drives the CUDA P-chase kernel behind the same contract.

Two layers sit between a backend and the simulator:

* **engine selection** — ``engine="vector"`` (default) steps whole index
  chunks through :class:`~repro_torch.core.cachesim.VectorCache`;
  ``engine="reference"`` replays the per-access oracle. Both produce
  bit-identical traces. ``engine="torch"`` routes through
  :class:`~repro_torch.core.cachesim_torch.BatchCache`, the port's twin
  of the JAX package's batched engine, whose scan runs as a CUDA kernel
  on the card (``device``), and exposes the batched entry points
  ``backend.batch(requests)`` and ``backend.steady_misses(configs)`` that
  the wave drivers in :mod:`repro_torch.core.inference` key on.
* **trace cache** — when a backend is given a ``trace_id`` and a process
  cache is configured (see :mod:`repro_torch.core.tracecache`), simulated
  traces are content-addressed and reused instead of being regenerated.
"""

from __future__ import annotations

from typing import Callable, Protocol, Sequence

import numpy as np

from repro_torch.core import tracecache
from repro_torch.core.cachesim import Cache, MemoryHierarchy, VectorCache
from repro_torch.core.trace import PChaseConfig, PChaseTrace


class TraceBackend(Protocol):
    def __call__(self, config: PChaseConfig,
                 indices: np.ndarray | None = None) -> PChaseTrace: ...


# ---------------------------------------------------------------------------
# Index-sequence construction
# ---------------------------------------------------------------------------


def uniform_chase_indices(config: PChaseConfig, passes: float = 1.0) -> np.ndarray:
    """Paper Listing 1: ``A[i] = (i + stride) % N`` chased from j=0.

    The visited sequence is simply ``(t * s) mod N`` in elements.
    """
    n, s = config.num_elems, config.stride_elems
    k = int(np.ceil(passes * n / s)) if passes else config.iterations
    return (np.arange(k, dtype=np.int64) * s) % n


def chase_from_array(array: np.ndarray, iterations: int, start: int = 0) -> np.ndarray:
    """Chase an arbitrarily-initialized array (the non-uniform-stride init
    of Fig 13b used by the latency-spectrum experiment)."""
    out = np.empty(iterations, dtype=np.int64)
    j = start
    for t in range(iterations):
        j = int(array[j])
        out[t] = j
    return out


# ---------------------------------------------------------------------------
# Simulator backends
# ---------------------------------------------------------------------------


def _chase_streams(config: PChaseConfig, indices: np.ndarray | None,
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(warmup, recorded) element-index streams for one config."""
    if indices is not None:
        # custom init (Fig 13b): caller controls warmup via the indices
        return np.empty(0, dtype=np.int64), np.asarray(indices, dtype=np.int64)
    if config.warmup_passes > 0:
        warm = uniform_chase_indices(config, passes=config.warmup_passes)
    else:
        warm = np.empty(0, dtype=np.int64)
    rec = np.resize(uniform_chase_indices(config), config.iterations)
    return warm, rec


def _vector_record_periodic(vec: VectorCache, rec: np.ndarray,
                            config: PChaseConfig,
                            ) -> tuple[np.ndarray, bool]:
    """Record a uniform multi-pass chase, fast-forwarding steady state.

    ``rec`` is periodic by construction (``np.resize`` of one pass), and
    under a deterministic policy the cache state at pass boundaries must
    eventually revisit a canonical signature; from that point the per-pass
    miss pattern tiles exactly.  The signature canonicalizes recency by
    *rank*, so the tiled hit/miss/latency streams are bit-exact with full
    simulation (the differential tests pin this against the reference
    oracle on multi-pass streams); the ``replaced_ways`` debug meta beyond
    the cycle point is exact only up to the unobservable physical-way
    permutation (meta carries ``steady_state_tiled`` when tiling fired).
    Stochastic policies never take this path: their RNG consumption must
    stay sequential.
    """
    eb = config.elem_bytes
    k = len(rec)
    period = max(1, int(np.ceil(config.num_elems / config.stride_elems)))
    if vec.geom.replacement.kind not in ("lru", "fifo") or k < 3 * period:
        return ~vec.access_chunk(rec * eb), False
    addrs = rec * eb
    miss = np.empty(k, dtype=bool)
    needed: set[int] | None = None
    sigs: dict[bytes, int] = {}
    rw_marks = [len(vec.replaced_ways)]
    t = 0
    while t + period <= k:
        miss[t:t + period] = ~vec.access_chunk(addrs[t:t + period])
        t += period
        rw_marks.append(len(vec.replaced_ways))
        if needed is None:
            needed = set((addrs[:period] // vec.geom.line_bytes).tolist())
        if not needed <= vec._ever_seen:
            continue                       # prefetch path still live
        sig = vec.state_signature()
        prev = sigs.get(sig)
        if prev is None:
            sigs[sig] = t // period
            continue
        # passes [prev, current) form a cycle: tile the remainder
        cyc_miss = miss[prev * period:t]
        cyc_rw = vec.replaced_ways[rw_marks[prev]:rw_marks[t // period]]
        while t < k:
            take = min(len(cyc_miss), k - t)
            miss[t:t + take] = cyc_miss[:take]
            n_miss = int(cyc_miss[:take].sum())
            # in a repeating cycle every set is full, so evictions align
            # one-to-one with misses in order
            vec.replaced_ways.extend(cyc_rw[:n_miss])
            vec.misses += n_miss
            vec.hits += take - n_miss
            t += take
        return miss, True
    if t < k:                              # no cycle found: finish directly
        miss[t:] = ~vec.access_chunk(addrs[t:])
    return miss, False


def cache_backend(make_cache: Callable[[], Cache], t_hit: float = 50.0,
                  t_miss_extra: float = 200.0, *, engine: str = "vector",
                  trace_id: str | None = None,
                  device: str = "cuda") -> TraceBackend:
    """Single-cache backend: latency = t_hit (+ t_miss_extra on miss).

    Used to dissect one cache structure in isolation, as the paper does by
    picking the access path (texture fetch, ``__ldg``, global load...).

    ``engine`` picks the stepping core (``"vector"`` chunks, ``"reference"``
    per-access oracle — bit-identical traces either way; ``"torch"`` the
    batched engine, bit-identical for deterministic policies and
    distributionally equivalent for stochastic ones, whose scan runs on
    ``device``: ``"cuda"`` unless the caller asks for ``"cpu"``; the numpy
    engines ignore it).  ``trace_id`` opts the backend into the process
    trace cache; pass one only when ``make_cache`` is deterministic (same
    structure and seed every call), which holds for all registered device
    factories.
    """
    if engine == "torch":
        return _torch_cache_backend(make_cache, t_hit, t_miss_extra,
                                    trace_id=trace_id, device=device)
    if engine not in ("vector", "reference"):
        raise ValueError(f"unknown engine {engine!r}")

    def run(config: PChaseConfig, indices: np.ndarray | None = None) -> PChaseTrace:
        warm, rec = _chase_streams(config, indices)
        tc = tracecache.default_cache() if trace_id else None
        key = None
        if tc is not None:
            # engine is part of the key although the engines are bit-exact:
            # engine="reference" exists to NOT trust that claim, so it must
            # never be served a vector-engine trace
            key = tc.key(trace_id, config,
                         extra={"backend": "cache", "engine": engine,
                                "t_hit": t_hit,
                                "t_miss_extra": t_miss_extra},
                         indices=indices)
            cached = tc.get(key, config, rebuild_indices=rec)
            if cached is not None:
                return cached
        cache = make_cache()
        tiled = False
        if engine == "vector":
            vec = VectorCache.from_cache(cache)
            n, s = config.num_elems, config.stride_elems
            period = max(1, -(-n // s))
            if indices is None and n % s == 0 and warm.size % period == 0:
                # warmup is phase-aligned tiles of the same pass, so fold
                # it into the periodic stream — steady-state tiling then
                # fast-forwards the warmup passes too
                full, tiled = _vector_record_periodic(
                    vec, np.concatenate([warm, rec]), config)
                miss = full[warm.size:]
            elif indices is None:
                if warm.size:
                    vec.access_chunk(warm * config.elem_bytes)
                miss, tiled = _vector_record_periodic(vec, rec, config)
            else:
                miss = ~vec.access_chunk(rec * config.elem_bytes)
            replaced = vec.replaced_ways
        else:
            for idx in warm:
                cache.access(int(idx) * config.elem_bytes)
            miss = np.empty(len(rec), dtype=bool)
            for t, idx in enumerate(rec):
                miss[t] = not cache.access(int(idx) * config.elem_bytes)
            replaced = cache.replaced_ways
        lat = np.where(miss, t_hit + t_miss_extra, t_hit)
        meta = {"true_miss": miss,
                "replaced_ways": list(replaced),
                "miss_threshold": t_hit + t_miss_extra / 2}
        if tiled:
            meta["steady_state_tiled"] = True
        trace = PChaseTrace(config, rec, lat, meta=meta)
        if tc is not None and key is not None:
            tc.put(key, trace, omit_indices=indices is None)
        return trace

    return run


def _torch_cache_backend(make_cache: Callable[[], Cache], t_hit: float,
                         t_miss_extra: float, *,
                         trace_id: str | None = None,
                         device: str = "cuda") -> TraceBackend:
    """``engine="torch"`` backend: batched closed-form/scan trace engine,
    the twin of the JAX package's ``_jax_cache_backend``.

    Same trace contract as the numpy engines, plus the batched entry
    points the wave drivers in :mod:`repro_torch.core.inference` key on:

    * ``run.batch(requests)`` — ``requests`` is a list of
      ``(config, indices)`` pairs; one engine call per wave.  Candidate
      lanes skip the trace-cache write-back (hundreds of one-shot probes
      would cost more disk I/O than their closed-form simulation), but
      still consult it for reads.
    * ``run.steady_misses(configs)`` — steady misses per pass of uniform
      chases in closed form, no trace materialized.  Entries are None
      where the lean path does not apply (the driver falls back to a
      full trace for those).

    Stochastic-policy traces would embed the torch RNG-lane draws, so the
    engine's traces are keyed under
    :data:`~repro_torch.core.cachesim.TORCH_ENGINE_VERSION` and never
    shared with the numpy engines.  ``replaced_ways`` debug meta is not
    produced (nothing outside the engine differential tests consumes it).
    """
    from repro_torch.core import cachesim_torch  # lazy: numpy-only
    #                                              callers never import torch

    geom = make_cache().geom
    if geom.replacement.kind not in ("lru", "fifo"):
        # Stochastic policies have no closed form, and a per-access scan
        # is linear in batch size — no batching win.  The serial
        # vector core is strictly faster here and keeps stochastic streams
        # bit-identical across engine selections (the BatchCache scan path
        # itself remains distributionally validated by the differential
        # tests).  Without the batched attributes the inference drivers
        # fall back to their serial loops.
        return cache_backend(make_cache, t_hit, t_miss_extra,
                             engine="vector", trace_id=trace_id)
    sim = cachesim_torch.BatchCache([geom], device=device)
    miss_threshold = t_hit + t_miss_extra / 2

    def _pass_line_addrs(config: PChaseConfig) -> np.ndarray | None:
        """Distinct line addresses one uniform-chase pass visits, each in
        a single consecutive run — or None when the chase does not tile
        (n % s != 0).  Computed from (N, s, line) directly; no per-access
        arrays, which is what makes ``steady_misses`` ~constant-time."""
        n, s = config.num_elems, config.stride_elems
        if n <= 0 or s <= 0 or n % s:
            return None
        eb, line = config.elem_bytes, geom.line_bytes
        s_bytes, n_bytes = s * eb, n * eb
        if s_bytes <= line:
            # contiguous coverage: every line below N is visited
            count = (n_bytes - s_bytes) // line + 1
            return np.arange(count, dtype=np.int64) * line
        addrs = (np.arange(n // s, dtype=np.int64) * s_bytes) // line * line
        return addrs

    def _period(config: PChaseConfig) -> int:
        return max(1, -(-config.num_elems // max(config.stride_elems, 1)))

    def _record(config: PChaseConfig, warm: np.ndarray,
                rec: np.ndarray) -> np.ndarray:
        """Recorded-portion miss mask, lane simulated from cold."""
        if (config.num_elems > 0 and config.stride_elems > 0
                and config.num_elems % config.stride_elems == 0):
            pattern = uniform_chase_indices(config) * config.elem_bytes
            masks = sim.periodic_masks(0, pattern)
            if masks is not None:
                cold, steady = masks
                total = warm.size + rec.size
                p = len(cold)
                miss = np.resize(steady, total)
                m = min(p, total)
                miss[:m] = cold[:m]
                return miss[warm.size:]
        stream = np.concatenate([warm, rec]) * config.elem_bytes
        hits = sim.simulate([stream])[0]
        return ~hits[warm.size:]

    def _run(config: PChaseConfig, indices: np.ndarray | None,
             store: bool) -> PChaseTrace:
        warm, rec = _chase_streams(config, indices)
        tc = tracecache.default_cache() if trace_id else None
        key = None
        if tc is not None:
            key = tc.key(trace_id, config, seed=sim.seed,
                         extra={"backend": "cache", "engine": "torch",
                                "t_hit": t_hit,
                                "t_miss_extra": t_miss_extra},
                         indices=indices,
                         engine_version=cachesim_torch.TORCH_ENGINE_VERSION)
            cached = tc.get(key, config, rebuild_indices=rec)
            if cached is not None:
                return cached
        if indices is not None:
            miss = ~sim.simulate([rec * config.elem_bytes])[0]
        else:
            miss = _record(config, warm, rec)
        lat = np.where(miss, t_hit + t_miss_extra, t_hit)
        trace = PChaseTrace(config, rec, lat,
                            meta={"true_miss": miss,
                                  "miss_threshold": miss_threshold})
        if store and tc is not None and key is not None:
            tc.put(key, trace, omit_indices=indices is None)
        return trace

    def run(config: PChaseConfig,
            indices: np.ndarray | None = None) -> PChaseTrace:
        return _run(config, indices, store=True)

    def batch(requests: Sequence[tuple[PChaseConfig, np.ndarray | None]],
              ) -> list[PChaseTrace]:
        return [_run(cfg, idx, store=False) for cfg, idx in requests]

    def steady_misses(configs: Sequence[PChaseConfig],
                      ) -> list[float | None]:
        out: list[float | None] = []
        for cfg in configs:
            val = None
            # exact iff the recorded stream is entirely steady state:
            # at least one warm pass and at least one full recorded pass
            if cfg.warmup_passes >= 1 and cfg.iterations >= _period(cfg):
                la = _pass_line_addrs(cfg)
                if la is not None:
                    val = sim.steady_miss_count(0, la)
            out.append(val)
        return out

    run.engine = "torch"          # type: ignore[attr-defined]
    run.batch = batch             # type: ignore[attr-defined]
    run.steady_misses = steady_misses  # type: ignore[attr-defined]
    return run


def hierarchy_backend(make_hierarchy: Callable[[], MemoryHierarchy],
                      warmup: bool = True,
                      trace_id: str | None = None) -> TraceBackend:
    """Full-hierarchy backend (data caches + TLBs + page table).

    The hierarchy interleaves per-access control flow across four caches
    and a page-table window, so it steps through the reference oracle; the
    trace cache (``trace_id``) still removes repeat simulation across
    sweeps.
    """

    def run(config: PChaseConfig, indices: np.ndarray | None = None) -> PChaseTrace:
        if indices is None:
            rec = np.resize(uniform_chase_indices(config), config.iterations)
        else:
            rec = np.asarray(indices, dtype=np.int64)
        tc = tracecache.default_cache() if trace_id else None
        key = None
        if tc is not None:
            key = tc.key(trace_id, config,
                         extra={"backend": "hierarchy", "warmup": warmup},
                         indices=indices)
            cached = tc.get(key, config, rebuild_indices=rec)
            if cached is not None:
                return cached
        h = make_hierarchy()
        h.reset()
        if warmup:
            warm = uniform_chase_indices(
                config, passes=max(1, config.warmup_passes))
            for idx in warm:
                h.access(int(idx) * config.elem_bytes)
        lats, infos = h.run_chase(rec, elem_bytes=config.elem_bytes)
        trace = PChaseTrace(config, rec, lats,
                            meta={"patterns": [i.get("pattern") for i in infos]})
        if tc is not None and key is not None:
            tc.put(key, trace, omit_indices=indices is None)
        return trace

    return run


# ---------------------------------------------------------------------------
# The three measurement methods
# ---------------------------------------------------------------------------


def fine_grained(backend: TraceBackend, array_bytes: int, stride_bytes: int,
                 iterations: int | None = None, elem_bytes: int = 4,
                 warmup_passes: int = 2, passes: float = 2.0) -> PChaseTrace:
    """The paper's method: full (index, latency) trace for one (N, s)."""
    cfg = PChaseConfig(array_bytes, stride_bytes, 0, elem_bytes, warmup_passes)
    if iterations is None:
        iterations = int(np.ceil(passes * cfg.num_elems / cfg.stride_elems))
    cfg = PChaseConfig(array_bytes, stride_bytes, iterations, elem_bytes,
                       warmup_passes)
    return backend(cfg)


def saavedra1992(backend: TraceBackend, array_bytes: int,
                 stride_list: Sequence[int], elem_bytes: int = 4,
                 passes: float = 4.0) -> dict[int, float]:
    """Classic method 1: tavg vs stride at fixed N (only averages kept)."""
    out = {}
    for s in stride_list:
        tr = fine_grained(backend, array_bytes, s, elem_bytes=elem_bytes,
                          passes=passes)
        out[s] = tr.tavg
    return out


def wong2010(backend: TraceBackend, array_bytes_list: Sequence[int],
             stride_bytes: int, elem_bytes: int = 4,
             passes: float = 4.0) -> dict[int, float]:
    """Classic method 2: tavg vs array size at fixed stride ≈ line size."""
    out = {}
    for n in array_bytes_list:
        tr = fine_grained(backend, n, stride_bytes, elem_bytes=elem_bytes,
                          passes=passes)
        out[n] = tr.tavg
    return out
