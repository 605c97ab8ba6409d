"""Parameterized cache / TLB / memory-hierarchy simulator.

A copy of ``repro/core/cachesim.py`` for the port: numpy and the
standard library only, nothing of ``repro``.

This is the CPU-side measurement substrate (see DESIGN.md §2): a
ground-truth oracle that can be configured with every structure the paper
discovered —

* classical equal-set set-associative caches (paper Assumptions 1–3),
* **unequal cache sets** (the L2 TLB's 17+6×8 structure, Fig 9),
* **non-bits-defined and non-adjacent set mappings** (texture L1 selects the
  set with address bits 7–8 instead of 5–6, Fig 7; Fermi L1 uses bits 9–11
  and 12–13, §4.5),
* **non-LRU replacement** (Fermi L1's way probabilities (1/6, 1/2, 1/6, 1/6),
  Fig 11; random replacement for the L2),
* **sequential DRAM→L2 prefetch** of ~2/3 the cache capacity (§4.6),
* multi-level composition with TLBs, page-table walks and the Kepler/Maxwell
  512 MB page-table context-switch window (P6, §5.2).

The fine-grained P-chase analyzer (``core.inference``) must recover all of
these *blind* — it only ever sees (index, latency) traces, never the
simulator internals.  ``meta`` fields carry internals for unit tests only.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
from typing import Callable, Sequence

import numpy as np

# Bumped whenever the observable trace semantics of either engine change;
# part of every trace-cache key (see core.tracecache) so stale cached
# traces can never leak across engine revisions.
ENGINE_VERSION = "trace-engine/2"

# Version of the batched jax engine (core.cachesim_jax).  Defined here —
# not in cachesim_jax — so the trace cache and profile staleness checks
# can name it without importing jax.  Bumped independently of
# ENGINE_VERSION: the jax engine's hit/miss streams are bit-identical to
# the oracle for deterministic policies but its stochastic-policy RNG
# lanes are only distributionally equivalent, so its traces must never be
# served to (or taken from) the numpy engines.
JAX_ENGINE_VERSION = "trace-engine-jax/1"

# Version of the port's batched torch engine (core.cachesim_torch), kept
# apart from both for the same reason: its stochastic lanes draw their
# uniforms from a torch.Generator, so its traces are neither the numpy
# engines' nor the jax engine's. Not part of registry_fingerprint().
TORCH_ENGINE_VERSION = "trace-engine-torch/1"

# ---------------------------------------------------------------------------
# Set-mapping functions: line address (bytes) -> set index
#
# Each factory attaches a ``vectorized`` attribute to the scalar closure —
# the same mapping applied to a whole int64 address chunk at once — which
# the vectorized engine uses to translate an entire chunk per call.
# ---------------------------------------------------------------------------


def modulo_map(line_bytes: int, num_sets: int) -> Callable[[int], int]:
    """Classic adjacent-bits mapping (paper Assumption 2)."""

    def _map(addr: int) -> int:
        return (addr // line_bytes) % num_sets

    _map.vectorized = lambda addrs: (addrs // line_bytes) % num_sets
    return _map


def bitfield_map(lo_bit: int, num_bits: int) -> Callable[[int], int]:
    """Set selected by address bits [lo_bit, lo_bit+num_bits).

    The texture L1 uses ``bitfield_map(7, 2)`` — bits 7–8 — rather than the
    traditional bits 5–6, which is exactly what breaks Wong2010 (Fig 4/5).
    """
    mask = (1 << num_bits) - 1

    def _map(addr: int) -> int:
        return (addr >> lo_bit) & mask

    _map.vectorized = lambda addrs: (addrs >> lo_bit) & mask
    return _map


def split_bitfield_map(fields: Sequence[tuple[int, int]]) -> Callable[[int], int]:
    """Set index concatenated from non-adjacent bit ranges.

    Models the Fermi L1 data cache's mapping (§4.5): bits 9–11 select the
    "major set" and bits 12–13 the group — ``[(9, 3), (12, 2)]`` — leaving
    bits 7–8 *unused*, which violates Assumption 2 in a second way.
    """
    fields = tuple((int(lo), int(nbits)) for lo, nbits in fields)

    def _map(addr: int) -> int:
        out, shift = 0, 0
        for lo, nbits in fields:
            out |= ((addr >> lo) & ((1 << nbits) - 1)) << shift
            shift += nbits
        return out

    def _vec(addrs: np.ndarray) -> np.ndarray:
        out = np.zeros_like(addrs)
        shift = 0
        for lo, nbits in fields:
            out |= ((addrs >> lo) & ((1 << nbits) - 1)) << shift
            shift += nbits
        return out

    _map.vectorized = _vec
    return _map


def range_cyclic_map(line_bytes: int, way_counts: Sequence[int]) -> Callable[[int], int]:
    """Unequal sets filled in contiguous ranges, wrapping at total capacity.

    Used for the L2 TLB (1×17 + 6×8 entries).  The paper under-determines
    the page→set function; this choice reproduces the observable it reports
    (overflowing by one page thrashes exactly the large set first, then the
    small sets one by one as N grows — Fig 8's piecewise-linear miss rate).
    """
    bounds = np.cumsum(np.asarray(way_counts, dtype=np.int64))
    total = int(bounds[-1])

    def _map(addr: int) -> int:
        q = (addr // line_bytes) % total
        return int(np.searchsorted(bounds, q, side="right"))

    _map.vectorized = lambda addrs: np.searchsorted(
        bounds, (addrs // line_bytes) % total, side="right").astype(np.int64)
    return _map


# ---------------------------------------------------------------------------
# Sorted, coalesced [lo, hi) interval sets (prefetch windows)
# ---------------------------------------------------------------------------


def _interval_add(los: list[int], his: list[int], lo: int, hi: int) -> None:
    """Insert [lo, hi) into a sorted disjoint interval list, coalescing any
    overlapping or adjacent intervals, so membership stays a binary search
    no matter how long the trace runs."""
    i = bisect.bisect_left(los, lo)
    if i > 0 and his[i - 1] >= lo:      # overlaps/abuts predecessor
        i -= 1
        lo = los[i]
        hi = max(hi, his[i])
    j = i
    while j < len(los) and los[j] <= hi:   # absorb successors
        hi = max(hi, his[j])
        j += 1
    los[i:j] = [lo]
    his[i:j] = [hi]


def _interval_contains(los: list[int], his: list[int], x: int) -> bool:
    i = bisect.bisect_right(los, x) - 1
    return i >= 0 and x < his[i]


# ---------------------------------------------------------------------------
# Single cache level
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReplacementPolicy:
    """``lru`` | ``fifo`` | ``random`` | ``prob``.

    ``prob`` replaces way *i* of a full set with probability
    ``way_probs[i]`` — the Fermi L1's measured behaviour is
    ``(1/6, 1/2, 1/6, 1/6)`` (§4.5, Fig 11).
    """

    kind: str = "lru"
    way_probs: tuple[float, ...] | None = None

    def __post_init__(self) -> None:
        if self.kind not in ("lru", "fifo", "random", "prob"):
            raise ValueError(f"unknown replacement policy {self.kind!r}")
        if self.kind == "prob":
            if not self.way_probs:
                raise ValueError("prob policy needs way_probs")
            if abs(sum(self.way_probs) - 1.0) > 1e-9:
                raise ValueError("way_probs must sum to 1")


LRU = ReplacementPolicy("lru")


@dataclasses.dataclass(frozen=True)
class CacheGeometry:
    """Full structural description of one cache level."""

    name: str
    line_bytes: int
    way_counts: tuple[int, ...]                   # per-set ways; unequal allowed
    set_map: Callable[[int], int] | None = None   # default: modulo_map
    replacement: ReplacementPolicy = LRU
    prefetch_lines: int = 0                       # sequential prefetch on compulsory miss

    @property
    def num_sets(self) -> int:
        return len(self.way_counts)

    @property
    def size_bytes(self) -> int:
        return self.line_bytes * sum(self.way_counts)

    @property
    def uniform_ways(self) -> int | None:
        ways = set(self.way_counts)
        return ways.pop() if len(ways) == 1 else None

    def mapper(self) -> Callable[[int], int]:
        return self.set_map or modulo_map(self.line_bytes, self.num_sets)

    def vector_mapper(self) -> Callable[[np.ndarray], np.ndarray]:
        """Chunk-at-a-time set mapping for the vectorized engine.

        Uses the factory-provided ``vectorized`` twin when present; custom
        scalar-only mappings fall back to an element loop (correct, slow).
        """
        m = self.set_map
        if m is None:
            lb, ns = self.line_bytes, self.num_sets
            return lambda addrs: (addrs // lb) % ns
        vec = getattr(m, "vectorized", None)
        if vec is not None:
            return vec
        return lambda addrs: np.fromiter(
            (m(int(a)) for a in addrs), dtype=np.int64, count=len(addrs))

    @staticmethod
    def uniform(name: str, size_bytes: int, line_bytes: int, num_sets: int,
                **kw) -> "CacheGeometry":
        ways, rem = divmod(size_bytes, line_bytes * num_sets)
        if rem:
            raise ValueError("size not divisible by line*sets")
        return CacheGeometry(name, line_bytes, (ways,) * num_sets, **kw)


class Cache:
    """One level.  ``access`` returns True on hit and updates state."""

    def __init__(self, geom: CacheGeometry, rng: np.random.Generator | None = None):
        self.geom = geom
        self._map = geom.mapper()
        self._rng = rng or np.random.default_rng(0)
        self.reset()

    def reset(self) -> None:
        # Per set: fixed physical way slots (tag or None) — way identity must
        # be stable or per-way replacement probabilities are meaningless —
        # plus a recency list of way indices (LRU order, oldest first).
        self._ways: list[list[int | None]] = [
            [None] * w for w in self.geom.way_counts]
        self._order: list[list[int]] = [[] for _ in self.geom.way_counts]
        self._ever_seen: set[int] = set()       # for compulsory-miss prefetch
        # Prefetched-but-not-yet-touched tag intervals [start, end); touching
        # one counts as a hit and promotes the line into the cache proper.
        # Kept sorted and coalesced so membership is O(log n) — long TLB
        # traces used to degrade quadratically on the old linear scan.
        self._pf_lo: list[int] = []
        self._pf_hi: list[int] = []
        self.hits = 0
        self.misses = 0
        self.replaced_ways: list[tuple[int, int]] = []  # (set_idx, way_idx) per eviction

    # -- internals ----------------------------------------------------------

    def _insert(self, set_idx: int, tag: int) -> None:
        slots = self._ways[set_idx]
        order = self._order[set_idx]
        if None in slots:                     # cold fill: first free slot
            way = slots.index(None)
            slots[way] = tag
            order.append(way)
            return
        pol = self.geom.replacement
        if pol.kind in ("lru", "fifo"):
            way = order[0]                    # oldest (FIFO never reorders)
        elif pol.kind == "random":
            way = int(self._rng.integers(len(slots)))
        else:                                 # prob: fixed per-way probabilities
            way = int(self._rng.choice(len(slots), p=np.asarray(pol.way_probs)))
        self.replaced_ways.append((set_idx, way))
        order.remove(way)
        order.append(way)
        slots[way] = tag

    # -- public -------------------------------------------------------------

    def probe(self, addr: int) -> bool:
        """Hit test with no state change (used by tests only)."""
        tag = addr // self.geom.line_bytes
        return tag in self._ways[self._map(addr)]

    @property
    def _prefetched(self) -> list[tuple[int, int]]:
        """Coalesced prefetch windows as (start, end) tag pairs."""
        return list(zip(self._pf_lo, self._pf_hi))

    def _in_prefetch(self, tag: int) -> bool:
        return _interval_contains(self._pf_lo, self._pf_hi, tag)

    def access(self, addr: int) -> bool:
        tag = addr // self.geom.line_bytes
        set_idx = self._map(addr)
        slots = self._ways[set_idx]
        if tag in slots:
            self.hits += 1
            if self.geom.replacement.kind == "lru":
                way = slots.index(tag)
                order = self._order[set_idx]
                order.remove(way)
                order.append(way)             # move to MRU
            return True
        if tag not in self._ever_seen and self._in_prefetch(tag):
            # Prefetched line: its first-ever touch is a hit; promote it.
            self.hits += 1
            self._ever_seen.add(tag)
            self._insert(set_idx, tag)
            return True
        self.misses += 1
        compulsory = tag not in self._ever_seen
        self._ever_seen.add(tag)
        self._insert(set_idx, tag)
        if compulsory and self.geom.prefetch_lines:
            # Sequential DRAM->L2 prefetch (§4.6): the next ~2/3-capacity of
            # lines stream in behind a compulsory miss, so arrays below the
            # prefetch window show no cold-miss pattern.
            _interval_add(self._pf_lo, self._pf_hi,
                          tag + 1, tag + 1 + self.geom.prefetch_lines)
        return False


# ---------------------------------------------------------------------------
# Vectorized stepping engine
# ---------------------------------------------------------------------------


def _group_positions(keys: np.ndarray) -> dict:
    """line key -> ascending positions within the chunk (lazy eviction
    re-candidacy index for the event loop)."""
    if keys.size == 0:
        return {}
    order = np.argsort(keys, kind="stable")   # stable: positions stay sorted
    kk = keys[order]
    brk = np.flatnonzero(np.diff(kk) != 0) + 1
    out: dict = {}
    start = 0
    for end in list(brk) + [order.size]:
        out[int(kk[start])] = order[start:end]
        start = end
    return out


class VectorCache:
    """Chunk-stepping twin of :class:`Cache` — same observable behaviour,
    advanced a whole index chunk per call.

    State lives in numpy arrays: per-set tag rows (``-1`` = empty slot) and
    a per-way timestamp plane that doubles as LRU recency (``lru``) or
    insertion time (``fifo``); prefetch windows are sorted coalesced
    interval arrays.  A chunk is processed event-driven: membership of the
    whole chunk is tested vectorized (binary search of ``tag·T + set`` keys
    against the sorted resident-key snapshot — no per-way gather), runs of
    hits are committed in bulk (LRU recency deduped to one write per
    distinct line), and only the *events* (misses and prefetch promotions —
    the points where state actually changes) run through the exact
    per-access reference semantics, consuming the RNG in the same order as
    :class:`Cache` so ``random``/``prob`` replacement streams are
    bit-identical.  An eviction re-candidates the evicted tag's next chunk
    position, so correctness never depends on the initial snapshot.

    ``Cache`` remains the ground-truth oracle; the differential test suite
    asserts bit-exact hit/miss/latency streams between the two engines.
    """

    #: block size for one event-loop pass; bounds snapshot staleness costs
    _BLOCK = 1 << 16

    def __init__(self, geom: CacheGeometry, rng: np.random.Generator | None = None):
        self.geom = geom
        self._ns = geom.num_sets
        self._vmap = geom.vector_mapper()
        self._rng = rng or np.random.default_rng(0)
        pol = geom.replacement
        self._pol = pol.kind
        self._probs = (np.asarray(pol.way_probs, dtype=np.float64)
                       if pol.way_probs else None)
        self.reset()

    @classmethod
    def from_cache(cls, cache: Cache) -> "VectorCache":
        """Twin a freshly-built reference cache (shares its RNG instance, so
        the stochastic replacement stream stays bit-identical)."""
        return cls(cache.geom, cache._rng)

    def reset(self) -> None:
        g = self.geom
        self._wl = np.asarray(g.way_counts, dtype=np.int64)
        w = int(self._wl.max())
        t = g.num_sets
        self._tags = np.full((t, w), -1, dtype=np.int64)
        self._stamp = np.full((t, w), -1, dtype=np.int64)
        self._filled = np.zeros(t, dtype=np.int64)
        self._way_of: dict[int, int] = {}     # resident key -> way index
        self._clock = 0
        self._ever_seen: set[int] = set()
        self._pf_lo: list[int] = []
        self._pf_hi: list[int] = []
        self.hits = 0
        self.misses = 0
        self.replaced_ways: list[tuple[int, int]] = []

    # A resident line is keyed ``tag * num_sets + set`` — one int64 per
    # line, totally ordered, so a whole chunk's membership is one
    # searchsorted against the sorted resident-key snapshot.
    def _key(self, s: int, tag: int) -> int:
        return tag * self._ns + s

    # -- scalar compatibility ------------------------------------------------

    def probe(self, addr: int) -> bool:
        tag = addr // self.geom.line_bytes
        s = int(self._vmap(np.asarray([addr], dtype=np.int64))[0])
        return self._key(s, tag) in self._way_of

    def access(self, addr: int) -> bool:
        return bool(self.access_chunk(np.asarray([addr], dtype=np.int64))[0])

    # -- chunk stepping ------------------------------------------------------

    def access_chunk(self, addrs: np.ndarray) -> np.ndarray:
        """Advance the cache over a whole address chunk; returns the per-
        access hit mask (True = hit), identical to mapping ``Cache.access``
        over the chunk."""
        addrs = np.ascontiguousarray(addrs, dtype=np.int64)
        k = addrs.size
        if k == 0:
            return np.zeros(0, dtype=bool)
        if k <= self._BLOCK:
            return self._step_block(addrs)
        return np.concatenate([self._step_block(addrs[i:i + self._BLOCK])
                               for i in range(0, k, self._BLOCK)])

    def _step_block(self, addrs: np.ndarray) -> np.ndarray:
        k = addrs.size
        ns = self._ns
        tags = addrs // self.geom.line_bytes
        sets = np.ascontiguousarray(self._vmap(addrs), dtype=np.int64)
        keys = tags * ns + sets
        t0 = self._clock
        self._clock += k

        # membership snapshot: binary search against sorted resident keys
        if self._way_of:
            resident = np.sort(np.fromiter(
                self._way_of.keys(), dtype=np.int64, count=len(self._way_of)))
            pos = np.searchsorted(resident, keys)
            np.clip(pos, 0, resident.size - 1, out=pos)
            hit = resident[pos] == keys
        else:
            hit = np.zeros(k, dtype=bool)
        # Initial event candidates: the FIRST snapshot-miss of each distinct
        # line only — an event always (re)inserts its line, so later uses
        # are hits until an eviction re-candidates them.  Commit runs mark
        # the skipped positions as hits.
        miss_at = np.flatnonzero(~hit)
        if miss_at.size:
            _, first = np.unique(keys[miss_at], return_index=True)
            heap = miss_at[np.sort(first)].tolist()   # ascending => heap
        else:
            heap = []
        groups: dict | None = None
        way_of = self._way_of
        ptr = 0
        while heap:
            i = heapq.heappop(heap)
            if i < ptr:                            # already handled
                continue
            key = int(keys[i])
            if key in way_of:                      # re-inserted since: a hit
                continue
            self._commit_hits(keys, hit, ptr, i, t0)
            s, tag = int(sets[i]), int(tags[i])
            hit[i] = self._event(s, tag, t0 + i)
            evicted = self._evicted_key
            if evicted is not None:
                # Re-candidate only the evicted line's NEXT use: a miss
                # there re-inserts it, and any later eviction re-pushes — so
                # one position per eviction keeps the heap O(events).
                if groups is None:
                    groups = _group_positions(keys)
                arr = groups.get(evicted)
                if arr is not None:
                    j = int(np.searchsorted(arr, i, side="right"))
                    if j < arr.size:
                        heapq.heappush(heap, int(arr[j]))
            ptr = i + 1
        self._commit_hits(keys, hit, ptr, k, t0)
        return hit

    def _commit_hits(self, keys: np.ndarray, hit: np.ndarray,
                     lo: int, hi: int, t0: int) -> None:
        """Fold a run of pure hits [lo, hi) into counters (and, for LRU,
        recency stamps — one write per distinct line, last touch wins).
        Valid because cache state is piecewise-constant between events."""
        if lo >= hi:
            return
        hit[lo:hi] = True
        self.hits += hi - lo
        if self._pol != "lru":
            return
        ns, stamp, way_of = self._ns, self._stamp, self._way_of
        if hi - lo == 1:                        # dominant case in thrash
            key = int(keys[lo])
            stamp[key % ns, way_of[key]] = t0 + lo
            return
        if hi - lo <= 24:                       # tiny run: skip np.unique
            seen = set()
            for j in range(hi - 1, lo - 1, -1):
                key = int(keys[j])
                if key not in seen:
                    seen.add(key)
                    stamp[key % ns, way_of[key]] = t0 + j
            return
        # first occurrence in the reversed segment == last touch
        uniq, ridx = np.unique(keys[hi - 1:lo - 1 if lo else None:-1],
                               return_index=True)
        for key, r in zip(uniq.tolist(), ridx.tolist()):
            stamp[key % ns, way_of[key]] = t0 + hi - 1 - r

    def _event(self, s: int, tag: int, t: int) -> bool:
        """One state-changing access, exactly mirroring ``Cache.access``'s
        non-hit path (including RNG draw order).  Returns hit/miss."""
        self._evicted_key = None
        if tag not in self._ever_seen and \
                _interval_contains(self._pf_lo, self._pf_hi, tag):
            self.hits += 1
            self._ever_seen.add(tag)
            self._insert(s, tag, t)
            return True
        self.misses += 1
        compulsory = tag not in self._ever_seen
        self._ever_seen.add(tag)
        self._insert(s, tag, t)
        if compulsory and self.geom.prefetch_lines:
            _interval_add(self._pf_lo, self._pf_hi,
                          tag + 1, tag + 1 + self.geom.prefetch_lines)
        return False

    def state_signature(self) -> bytes:
        """Canonical state for deterministic-policy cycle detection:
        resident tags in timestamp-rank order per set, plus fill counts.
        Two states with equal signatures evolve identically under lru/fifo
        on equal future chunks — provided every chunk tag is already in
        ``_ever_seen`` (so the prefetch path is dead); callers must check
        that before comparing signatures.
        """
        order = np.argsort(self._stamp, axis=1, kind="stable")
        canon = np.take_along_axis(self._tags, order, axis=1)
        return canon.tobytes() + self._filled.tobytes()

    def _insert(self, s: int, tag: int, t: int) -> None:
        wl = int(self._wl[s])
        f = int(self._filled[s])
        if f < wl:                                 # cold fill: first free way
            w = f
            self._filled[s] = f + 1
        else:
            if self._pol in ("lru", "fifo"):
                w = int(self._stamp[s, :wl].argmin())
            elif self._pol == "random":
                w = int(self._rng.integers(wl))
            else:                                  # prob
                w = int(self._rng.choice(wl, p=self._probs))
            evicted = int(self._tags[s, w])
            self._evicted_key = self._key(s, evicted)
            del self._way_of[self._evicted_key]
            self.replaced_ways.append((s, w))
        self._tags[s, w] = tag
        self._stamp[s, w] = t
        self._way_of[self._key(s, tag)] = w


# ---------------------------------------------------------------------------
# Hierarchy: L1/L2 data caches + L1/L2 TLB + page table
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    """Cycle constants for one device (calibrated in core/devices.py)."""

    l1_hit: float
    l2_hit: float
    dram: float
    l1tlb_miss: float          # extra cycles when L1 TLB misses, L2 TLB hits
    pagewalk: float            # extra cycles when both TLBs miss
    context_switch: float = 0  # P6: page-table context switch (Kepler/Maxwell)


@dataclasses.dataclass
class MemoryHierarchy:
    """Composable device model.  Any level may be None (e.g. no L1)."""

    name: str
    latency: LatencyModel
    l1: Cache | None = None
    l2: Cache | None = None
    l1tlb: Cache | None = None
    l2tlb: Cache | None = None
    page_bytes: int = 2 << 20
    # Maxwell: "L1 data cache addressing does not go through the TLBs" (§5.2-2)
    l1_virtually_addressed: bool = False
    # Kepler/Maxwell: only a 512 MB window of page entries is active (P6)
    active_window_bytes: int | None = None
    _window_start: int = dataclasses.field(default=0, init=False)

    def reset(self) -> None:
        for c in (self.l1, self.l2, self.l1tlb, self.l2tlb):
            if c is not None:
                c.reset()
        self._window_start = 0

    def access(self, addr: int) -> tuple[float, dict]:
        """One load.  Returns (cycles, info) with per-level hit booleans."""
        lat = self.latency
        info: dict[str, bool | str] = {}

        # Virtually-addressed L1 short-circuits translation entirely.
        if self.l1 is not None and self.l1_virtually_addressed:
            if self.l1.access(addr):
                info["l1"] = True
                info["pattern"] = "P1"
                return lat.l1_hit, info
            info["l1"] = False

        cycles = 0.0
        # -- translation --
        tlb_state = "hit"
        if self.l1tlb is not None:
            page_addr = (addr // self.page_bytes) * self.page_bytes
            if self.l1tlb.access(page_addr):
                info["l1tlb"] = True
            else:
                info["l1tlb"] = False
                if self.l2tlb is not None and self.l2tlb.access(page_addr):
                    info["l2tlb"] = True
                    cycles += lat.l1tlb_miss
                    tlb_state = "l1tlb_miss"
                else:
                    info["l2tlb"] = False
                    cycles += lat.pagewalk
                    tlb_state = "pagewalk"
                    if self.active_window_bytes is not None:
                        win = self.active_window_bytes
                        if not (self._window_start <= addr < self._window_start + win):
                            cycles += lat.context_switch
                            self._window_start = (addr // win) * win
                            tlb_state = "context_switch"

        # -- data --
        if self.l1 is not None and not self.l1_virtually_addressed:
            if self.l1.access(addr):
                info["l1"] = True
                info["pattern"] = _classify(True, None, tlb_state)
                return cycles + lat.l1_hit, info
            info["l1"] = False
        if self.l2 is not None and self.l2.access(addr):
            info["l2"] = True
            info["pattern"] = _classify(False, True, tlb_state)
            return cycles + lat.l2_hit, info
        if self.l2 is not None:
            info["l2"] = False
        info["pattern"] = _classify(False, False, tlb_state)
        return cycles + lat.dram, info

    def run_chase(self, indices: np.ndarray, elem_bytes: int = 4,
                  base_addr: int = 0) -> tuple[np.ndarray, list[dict]]:
        """Drive the hierarchy with a pointer-chase index sequence."""
        lats = np.empty(len(indices), dtype=np.float64)
        infos: list[dict] = []
        for i, idx in enumerate(indices):
            cyc, info = self.access(base_addr + int(idx) * elem_bytes)
            lats[i] = cyc
            infos.append(info)
        return lats, infos


def _classify(l1_hit: bool, l2_hit: bool | None, tlb: str) -> str:
    """Label with the paper's Fig 14 pattern names (simulator meta only)."""
    if tlb == "context_switch":
        return "P6"
    cached = l1_hit or bool(l2_hit)
    if cached:
        return {"hit": "P1", "l1tlb_miss": "P2", "pagewalk": "P3"}[tlb]
    return {"hit": "P4", "l1tlb_miss": "P5", "pagewalk": "P5"}[tlb]
