"""Blind cache-parameter recovery from fine-grained P-chase traces.

A copy of ``repro/core/inference.py`` for the port: numpy and the
standard library only, nothing of ``repro``.

Implements the paper's two-stage procedure (Fig 6) plus the extra analyses
the fine-grained trace makes possible:

* cache size ``C``           — overflow search (stage 0)
* line size ``b``            — overflow-by-one, miss-count jump (stage 1)
* set structure ``T``/ways   — overflow line-by-line; *unequal* sets are
                               recovered from miss-count breakpoints (§4.4)
* replacement policy         — periodicity test; if non-LRU, reconstruct the
                               eviction chain and estimate per-way
                               replacement probabilities (Fig 11)
* set-mapping address bits   — conflict-stride probe (recovers e.g. the
                               texture L1's bits-7–8 mapping, Fig 7)

Everything here consumes only ``(index, latency)`` traces through a
:class:`~repro_torch.core.pchase.TraceBackend`; simulator internals are never
read.  The same code analyzes the CUDA P-chase kernel's traces on real
hardware.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.pchase import TraceBackend, fine_grained
from repro_torch.core.trace import PChaseConfig, PChaseTrace


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _miss_mask(trace: PChaseTrace) -> np.ndarray:
    thr = trace.meta.get("miss_threshold")
    return trace.miss_mask(thr)


def _accesses_per_pass(cfg: PChaseConfig) -> int:
    return max(1, math.ceil(cfg.num_elems / cfg.stride_elems))


def _per_pass_misses(tr: PChaseTrace) -> float:
    """Average steady-state miss count per full traversal, from a trace."""
    per_pass = _accesses_per_pass(tr.config)
    n_pass = len(tr.indices) // per_pass
    if n_pass == 0:
        return float(_miss_mask(tr).sum())
    mask = _miss_mask(tr)[: n_pass * per_pass].reshape(n_pass, per_pass)
    return float(mask.sum(axis=1).mean())


def misses_per_pass(backend: TraceBackend, array_bytes: int, stride_bytes: int,
                    passes: int = 4, elem_bytes: int = 4,
                    warmup_passes: int = 2) -> float:
    """Average steady-state miss count per full traversal of the array."""
    tr = fine_grained(backend, array_bytes, stride_bytes,
                      elem_bytes=elem_bytes, warmup_passes=warmup_passes,
                      passes=passes)
    return _per_pass_misses(tr)


# ---------------------------------------------------------------------------
# Wave evaluation (batched engines)
# ---------------------------------------------------------------------------

#: probes evaluated per engine call by the batched search drivers
_WAVE = 16


def _is_batched(backend: TraceBackend) -> bool:
    """Does the backend expose the batched entry points (engine="torch")?"""
    return getattr(backend, "steady_misses", None) is not None


def _probe_cfg(array_bytes: int, stride_bytes: int, passes: float,
               elem_bytes: int, warmup_passes: int = 2) -> PChaseConfig:
    """The config ``fine_grained`` would build for the same probe."""
    cfg = PChaseConfig(array_bytes, stride_bytes, 0, elem_bytes,
                       warmup_passes)
    iters = int(np.ceil(passes * cfg.num_elems / cfg.stride_elems))
    return PChaseConfig(array_bytes, stride_bytes, iters, elem_bytes,
                        warmup_passes)


def _misses_per_pass_many(backend: TraceBackend,
                          probes: list[tuple[int, int, float, int]],
                          ) -> list[float]:
    """Steady misses-per-pass for many ``(N, stride, passes, elem_bytes)``
    probes — through the backend's lean closed-form path where it has one,
    serial full traces otherwise (including lean-path gaps: non-tiling
    chases and stochastic policies)."""
    cfgs = [_probe_cfg(*p) for p in probes]
    lean = getattr(backend, "steady_misses", None)
    vals = lean(cfgs) if lean is not None else [None] * len(cfgs)
    return [(_per_pass_misses(backend(cfg)) if v is None else float(v))
            for cfg, v in zip(cfgs, vals)]


def _wave_grid(lo: int, hi: int, granularity: int,
               wave: int = _WAVE) -> list[int]:
    """≤``wave`` granularity-aligned interior points of ``(lo, hi)``."""
    pts = {((lo + (hi - lo) * i // (wave + 1)) // granularity) * granularity
           for i in range(1, wave + 1)}
    return sorted(p for p in pts if lo < p < hi)


# ---------------------------------------------------------------------------
# Stage 0: cache size
# ---------------------------------------------------------------------------


def find_cache_size(backend: TraceBackend, *, n_max: int, n_min: int = 0,
                    stride_bytes: int = 4, granularity: int = 4,
                    elem_bytes: int = 4) -> int:
    """Largest N with zero steady-state misses (paper step 1).

    All-hit is monotone in N (N ≤ C never evicts), so we binary-search
    instead of the paper's linear sweep — same measurement, fewer runs.
    Batched backends evaluate the whole doubling ladder, then a grid of
    midpoints per bisection wave, in single engine calls; endpoints stay
    granularity-aligned, so wave and serial search return the same N.
    """

    def all_hit(n: int) -> bool:
        tr = fine_grained(backend, n, stride_bytes, elem_bytes=elem_bytes,
                          warmup_passes=2, passes=2.0)
        return _miss_mask(tr).sum() == 0

    if n_min <= 0:
        n_min = granularity
    if _is_batched(backend):
        return _find_cache_size_batched(
            backend, n_max=n_max, n_min=n_min, stride_bytes=stride_bytes,
            granularity=granularity, elem_bytes=elem_bytes)
    # grow until first miss
    hi = n_min
    while hi <= n_max and all_hit(hi):
        hi *= 2
    if hi > n_max:
        raise ValueError(f"no miss up to n_max={n_max}; cache larger than probe range")
    lo = hi // 2  # all-hit
    while hi - lo > granularity:
        mid = ((lo + hi) // 2) // granularity * granularity
        if mid <= lo:
            break
        if all_hit(mid):
            lo = mid
        else:
            hi = mid
    return lo


def _find_cache_size_batched(backend: TraceBackend, *, n_max: int,
                             n_min: int, stride_bytes: int,
                             granularity: int, elem_bytes: int) -> int:
    def all_hit(ns: list[int]) -> dict[int, bool]:
        vals = _misses_per_pass_many(
            backend, [(n, stride_bytes, 2.0, elem_bytes) for n in ns])
        return {n: v == 0.0 for n, v in zip(ns, vals)}

    ladder = []
    n = n_min
    while n <= n_max:
        ladder.append(n)
        n *= 2
    hit = all_hit(ladder)
    fails = [n for n in ladder if not hit[n]]
    if not fails:
        raise ValueError(f"no miss up to n_max={n_max}; "
                         "cache larger than probe range")
    hi = fails[0]
    lo = hi // 2
    while hi - lo > granularity:
        mids = _wave_grid(lo, hi, granularity)
        if not mids:
            break
        res = all_hit(mids)
        bad = [m for m in mids if not res[m]]
        if bad:
            hi = min(bad)
        lo = max([m for m in mids if res[m] and m < hi], default=lo)
    return lo


# ---------------------------------------------------------------------------
# Stage 1: line size (+ LRU hint)
# ---------------------------------------------------------------------------


def find_line_size(backend: TraceBackend, cache_bytes: int, *,
                   elem_bytes: int = 4, stride_bytes: int | None = None,
                   max_line: int = 1 << 16, granularity: int | None = None,
                   passes: int = 8, jump_ratio: float = 1.6) -> int:
    """Line size from an overflow-by-one-element trace (paper step 2).

    Two signals, take the smaller (each is exact in its regime):

    * **fine-grained** — at N = C + 1 element the steady-state missed
      addresses are exactly the over-subscribed set's line starts; when the
      mapping puts *adjacent* lines in one set (texture bits-7–8, Fermi L1
      bits-9–13, the TLBs) their minimum gap IS the line size.  This is the
      case classic P-chase gets wrong (Fig 4/5).
    * **classic jump** — for adjacent-bits mappings (Assumption 2 holds)
      consecutive lines land in different sets, so the min-gap is T·b, but
      misses/pass jumps ×2 once δ crosses b + 1 element; binary-search the
      jump.
    """
    g = granularity or elem_bytes
    s = stride_bytes or elem_bytes
    candidates: list[int] = []

    tr = fine_grained(backend, cache_bytes + g, s, elem_bytes=elem_bytes,
                      warmup_passes=2, passes=passes)
    addrs = np.sort(np.unique(tr.indices[_miss_mask(tr)])) * elem_bytes
    if len(addrs) >= 2:
        candidates.append(int(np.diff(addrs).min()))

    try:
        # the jump search's baseline is exactly the trace above — reuse it
        # instead of regenerating the overflow-by-one stream
        candidates.append(_line_size_by_jump(
            backend, cache_bytes, stride_bytes=s, elem_bytes=elem_bytes,
            granularity=g, max_line=max_line, passes=passes,
            jump_ratio=jump_ratio, base=_per_pass_misses(tr)))
    except ValueError:
        pass
    if not candidates:
        raise ValueError("could not determine line size")
    best = min(candidates)
    # Lines (and pages) are powers of two; snap to absorb stochastic noise
    # in the jump location under non-deterministic replacement.
    return 1 << round(math.log2(best))


def _line_size_by_jump(backend: TraceBackend, cache_bytes: int, *,
                       stride_bytes: int, elem_bytes: int, granularity: int,
                       max_line: int, passes: int, jump_ratio: float,
                       base: float | None = None) -> int:
    """The paper's original signal: m(δ) jumps at δ = b + 1 element."""
    if base is None:
        base = misses_per_pass(backend, cache_bytes + granularity,
                               stride_bytes, passes=passes,
                               elem_bytes=elem_bytes)
    if base <= 0:
        raise ValueError("no misses when overflowing by one element")
    if _is_batched(backend):
        return _line_jump_batched(
            backend, cache_bytes, stride_bytes=stride_bytes,
            elem_bytes=elem_bytes, granularity=granularity,
            max_line=max_line, passes=passes, jump_ratio=jump_ratio,
            base=base)

    def jumped(delta: int) -> bool:
        m = misses_per_pass(backend, cache_bytes + delta, stride_bytes,
                            passes=passes, elem_bytes=elem_bytes)
        return m >= jump_ratio * base

    lo, hi = granularity, 2 * granularity
    while hi <= 2 * max_line and not jumped(hi):
        lo, hi = hi, hi * 2
    if hi > 2 * max_line:
        raise ValueError("no miss-count jump found below max_line")
    while hi - lo > granularity:
        mid = ((lo + hi) // 2) // granularity * granularity
        if mid <= lo:
            break
        if jumped(mid):
            hi = mid
        else:
            lo = mid
    return hi - granularity


def _line_jump_batched(backend: TraceBackend, cache_bytes: int, *,
                       stride_bytes: int, elem_bytes: int, granularity: int,
                       max_line: int, passes: int, jump_ratio: float,
                       base: float) -> int:
    def jumped(deltas: list[int]) -> dict[int, bool]:
        vals = _misses_per_pass_many(
            backend, [(cache_bytes + d, stride_bytes, float(passes),
                       elem_bytes) for d in deltas])
        return {d: v >= jump_ratio * base for d, v in zip(deltas, vals)}

    g = granularity
    ladder = []
    d = 2 * g
    while d <= 2 * max_line:
        ladder.append(d)
        d *= 2
    jm = jumped(ladder)
    firsts = [d for d in ladder if jm[d]]
    if not firsts:
        raise ValueError("no miss-count jump found below max_line")
    hi = firsts[0]
    lo = hi // 2
    while hi - lo > g:
        mids = _wave_grid(lo, hi, g)
        if not mids:
            break
        res = jumped(mids)
        bad = [m for m in mids if res[m]]
        if bad:
            hi = min(bad)
        lo = max([m for m in mids if not res[m] and m < hi], default=lo)
    return hi - g


# ---------------------------------------------------------------------------
# Stage 2: set structure (equal or unequal)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SetStructure:
    way_counts: list[int]         # per discovered set, discovery order
    uniform: bool
    num_sets: int
    assoc: float                  # C / (b · T) — may be fractional (L2!)


def conflict_set_ways(backend: TraceBackend, cache_bytes: int,
                      line_bytes: int, *, elem_bytes: int = 4,
                      passes: int = 8) -> int:
    """Ways of the set overflowed at N = C + b: the distinct missed lines in
    steady state are exactly that set's lines ⇒ ways = #lines − 1."""
    tr = fine_grained(backend, cache_bytes + line_bytes, line_bytes,
                      elem_bytes=elem_bytes, warmup_passes=2, passes=passes)
    missed = np.unique(tr.indices[_miss_mask(tr)] * elem_bytes // line_bytes)
    return max(0, len(missed) - 1)


def recover_set_structure(backend: TraceBackend, cache_bytes: int,
                          line_bytes: int, *, elem_bytes: int = 4,
                          passes: int = 4, max_steps: int = 512,
                          new_set_threshold: float = 2.0) -> SetStructure:
    """Overflow line by line (paper step 3).

    Each miss-per-pass increment Δm ≥ 2 marks a set beginning to thrash,
    with way count Δm − 1; Δm ≈ 1 extends an already-thrashing set.  The
    sweep ends when every access misses.  Equal-set caches produce identical
    jumps (Assumption 1 holds); the L2 TLB produces the 17-then-8s staircase
    (Assumption 1 violated, Fig 8/9).
    """
    way_counts: list[int] = []
    prev = 0.0
    lines_total = cache_bytes // line_bytes
    # batched backends take the staircase in waves; the early-stop check
    # still runs per step on the host, so at most one wave is overshoot
    wave = _WAVE if _is_batched(backend) else 1
    j, done = 1, False
    while j <= max_steps and not done:
        chunk = list(range(j, min(j + wave - 1, max_steps) + 1))
        ms = _misses_per_pass_many(
            backend, [(cache_bytes + jj * line_bytes, line_bytes,
                       float(passes), elem_bytes) for jj in chunk])
        for jj, m in zip(chunk, ms):
            dm = m - prev
            if dm >= new_set_threshold:
                way_counts.append(int(round(dm)) - 1)
            prev = m
            per_pass = math.ceil(lines_total + jj)
            if m >= 0.999 * per_pass:  # all sets thrash: structure exposed
                done = True
                break
        j = chunk[-1] + 1
    uniform = len(set(way_counts)) <= 1
    t = len(way_counts)
    assoc = cache_bytes / (line_bytes * t) if t else float("nan")
    return SetStructure(way_counts, uniform, t, assoc)


# ---------------------------------------------------------------------------
# Stage 2b: replacement policy (paper step 4 / Fig 11)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ReplacementReport:
    is_lru: bool
    way_probs: list[float] | None   # estimated replacement probabilities
    evictions: int                  # reconstruction sample size


def detect_replacement(backend: TraceBackend, cache_bytes: int,
                       line_bytes: int, *, elem_bytes: int = 4,
                       passes: int = 60) -> ReplacementReport:
    """Periodicity test + eviction-chain reconstruction.

    With N = C + b only one set is over-subscribed, by one line, so exactly
    one of its lines is absent at any instant.  Hence the victim of miss t
    is the line that misses at t+1 — the missed-line sequence IS the
    eviction chain.  Way labels are built lazily from the chain itself
    (each first-seen victim sits in a not-yet-labelled physical way), so no
    cold-fill assumption is needed; counts begin once all labels exist.
    The recovered probabilities equal the true per-way probabilities up to
    the (unobservable) way permutation — the paper's Fig 11 analysis,
    automated.
    """
    tr = fine_grained(backend, cache_bytes + line_bytes, line_bytes,
                      elem_bytes=elem_bytes, warmup_passes=2, passes=passes)
    mask = _miss_mask(tr)
    lines = tr.indices * elem_bytes // line_bytes

    period = _accesses_per_pass(tr.config)
    is_lru = True
    if mask.size >= 2 * period:
        folded = mask[: (mask.size // period) * period].reshape(-1, period)
        is_lru = bool((folded == folded[0]).all())
        # LRU with one-line overflow also implies the conflict set misses on
        # every access; a periodic-but-partial pattern is still non-LRU.
        if is_lru:
            conflict_lines = np.unique(lines[mask])
            for ln in conflict_lines:
                ln_mask = mask[lines == ln]
                if not ln_mask.all():
                    is_lru = False
                    break
    if is_lru:
        return ReplacementReport(True, None, 0)

    # --- eviction-chain reconstruction on the conflict set ---
    missed_lines = lines[mask]
    conflict = np.unique(missed_lines)
    ways = len(conflict) - 1
    if ways <= 0:
        return ReplacementReport(False, None, 0)
    slot_of: dict[int, int] = {}
    next_label = 0
    counts = np.zeros(ways, dtype=np.int64)
    seq = [int(x) for x in missed_lines]
    for t in range(len(seq) - 1):
        victim = seq[t + 1]
        w = slot_of.pop(victim, None)
        if w is None:                   # victim in a way we haven't labelled
            if next_label >= ways:      # chain glitch (shouldn't happen)
                continue
            w = next_label
            next_label += 1
        elif next_label >= ways:        # all ways labelled: count this one
            counts[w] += 1
        slot_of[seq[t]] = w
    total = int(counts.sum())
    probs = (counts / total).tolist() if total else None
    return ReplacementReport(False, probs, total)


# ---------------------------------------------------------------------------
# Set-mapping address bits (conflict-stride probe)
# ---------------------------------------------------------------------------


def find_set_bits(backend: TraceBackend, line_bytes: int, ways: int,
                  num_sets: int, *, elem_bytes: int = 4,
                  max_log2: int = 20, passes: int = 6) -> tuple[int, int]:
    """Recover which address bits select the set.

    Probe: chase ``ways+1`` lines spaced 2^p apart.  If the spacing keeps
    all lines in one set they thrash (all miss); the smallest such p bounds
    the top of the set-index field, and ``log2(num_sets)`` bits below it
    form the field.  Texture L1 ⇒ (7, 9) i.e. bits 7–8 (Fig 7); a classical
    cache of the same shape ⇒ (5, 7).
    """
    n_lines = ways + 1

    def probe(p: int) -> tuple[PChaseConfig, np.ndarray]:
        spacing = 1 << p
        addrs = np.arange(n_lines, dtype=np.int64) * (spacing // elem_bytes)
        idx = np.resize(addrs, n_lines * passes)
        n_bytes = int(addrs[-1] * elem_bytes + line_bytes)
        return PChaseConfig(n_bytes, spacing, len(idx), elem_bytes, 0), idx

    ps = list(range(int(math.log2(line_bytes)), max_log2 + 1))
    run_batch = getattr(backend, "batch", None)
    wave = _WAVE if run_batch is not None else 1
    for i in range(0, len(ps), wave):
        chunk = ps[i:i + wave]
        reqs = [probe(p) for p in chunk]
        if run_batch is not None:
            traces = run_batch(reqs)
        else:
            traces = [backend(cfg, indices=idx) for cfg, idx in reqs]
        for p, tr in zip(chunk, traces):
            steady = _miss_mask(tr)[n_lines:]
            if steady.size and steady.all():
                lo = p - int(round(math.log2(num_sets)))
                return (lo, p)
    raise ValueError("no conflict stride found: cache may be fully associative")


# ---------------------------------------------------------------------------
# Orchestrated dissection (the whole Fig 6 flowchart)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CacheParams:
    size_bytes: int
    line_bytes: int
    num_sets: int
    assoc: float
    way_counts: list[int]
    uniform_sets: bool
    is_lru: bool
    way_probs: list[float] | None = None
    set_bits: tuple[int, int] | None = None

    def summary(self) -> str:
        pol = "LRU" if self.is_lru else (
            f"non-LRU p={['%.3f' % p for p in self.way_probs]}"
            if self.way_probs else "non-LRU")
        bits = (f" set-bits[{self.set_bits[0]},{self.set_bits[1]})"
                if self.set_bits else "")
        return (f"C={self.size_bytes}B b={self.line_bytes}B T={self.num_sets} "
                f"a={self.assoc:g} ways={self.way_counts} {pol}{bits}")


def dissect(backend: TraceBackend, *, n_max: int, elem_bytes: int = 4,
            stride_for_size: int | None = None, granularity: int | None = None,
            max_line: int = 1 << 16, probe_set_bits: bool = True,
            structure_max_steps: int = 128,
            line_stride_bytes: int | None = None,
            set_bits_max_log2: int = 20) -> CacheParams:
    """Run the full two-stage procedure against one cache path.

    ``line_stride_bytes`` sets the chase stride of the line-size stage — a
    TLB dissection strides by the expected page size instead of crawling
    4-byte elements across a 32 MB reach.  ``set_bits_max_log2`` bounds the
    conflict-stride probe (page-grain mappings need spacings past 2^20).
    """
    g = granularity or elem_bytes
    size = find_cache_size(backend, n_max=n_max, granularity=g,
                           stride_bytes=stride_for_size or elem_bytes,
                           elem_bytes=elem_bytes)
    line = find_line_size(backend, size, elem_bytes=elem_bytes,
                          stride_bytes=line_stride_bytes,
                          max_line=max_line, granularity=g)
    ways0 = conflict_set_ways(backend, size, line, elem_bytes=elem_bytes)
    repl = detect_replacement(backend, size, line, elem_bytes=elem_bytes)
    if repl.is_lru:
        struct = recover_set_structure(backend, size, line,
                                       elem_bytes=elem_bytes,
                                       max_steps=structure_max_steps)
        if not struct.way_counts:           # fully associative single set
            struct = SetStructure([ways0], True, 1, size / line)
    else:
        # Miss-count staircases are stochastic under non-LRU replacement;
        # derive T from C = T·a·b with a from the conflict set (paper §4.5).
        t = int(round(size / (line * max(1, ways0))))
        struct = SetStructure([ways0] * t, True, t, float(ways0))
    num_sets = struct.num_sets
    set_bits = None
    if probe_set_bits and num_sets > 1 and struct.uniform:
        try:
            set_bits = find_set_bits(backend, line, struct.way_counts[0],
                                     num_sets, elem_bytes=elem_bytes,
                                     max_log2=set_bits_max_log2)
        except ValueError:
            set_bits = None
    return CacheParams(
        size_bytes=size, line_bytes=line, num_sets=num_sets,
        assoc=struct.assoc if struct.way_counts else float(ways0),
        way_counts=struct.way_counts, uniform_sets=struct.uniform,
        is_lru=repl.is_lru, way_probs=repl.way_probs, set_bits=set_bits)
