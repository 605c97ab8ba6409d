"""Global-memory latency spectrum (paper §5.2, Fig 13b/14).

A copy of ``repro/core/spectrum.py`` for the port: numpy and the
standard library only, nothing of ``repro``.

The paper's trick: instead of one uniform stride, the chase array is
initialized with **non-uniform strides** so a single fine-grained run walks
through every access-pattern class P1–P6:

  P1  data-cache hit
  P2  data-cache hit, L1 TLB miss, L2 TLB hit
  P3  data-cache hit, L2 TLB miss (page-table walk)
  P4  data-cache miss, TLB hit
  P5  data-cache miss, TLB miss (cold)
  P6  page-table context switch (Kepler/Maxwell only: touching a page
      entry outside the 512 MB active window)

We build the phase program explicitly (addresses below), chase it through a
:class:`~repro_torch.core.cachesim.MemoryHierarchy`, and recover one latency per
pattern from the phase-median of the recorded trace.  Phase boundaries are
part of the *experiment design* (as in the paper), not leaked simulator
state.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.cachesim import MemoryHierarchy
from repro_torch.core.trace import PChaseConfig, PChaseTrace

MB = 1 << 20


@dataclasses.dataclass
class SpectrumPhase:
    pattern: str
    addrs: np.ndarray          # byte addresses, in chase order
    steady_from: int = 0       # ignore this many leading accesses (setup)


def build_phases(page_bytes: int = 2 * MB, line_bytes: int = 32,
                 l1tlb_entries: int = 16, l2tlb_entries: int = 65,
                 prefetch_reach_bytes: int = 3 * MB // 2,
                 active_window_bytes: int = 512 * MB,
                 has_window: bool = True,
                 spread_bytes: int = 1536) -> list[SpectrumPhase]:
    """The non-uniform-stride program, one phase per pattern.

    Mirrors the paper's recipe: big strides (s1 = 32 MB) build TLB+cache
    misses, strides inside a mapped page build cache-miss/TLB-hit, revisits
    of cached lines with big strides build cache-hit/TLB-miss, and an
    intra-line crawl builds pure hits.  Two experiment-design details the
    fine-grained view forces:

    * the P4 offset is pushed past the L2 prefetch reach so the prefetcher
      (§4.6) cannot convert it into a hit;
    * ring elements carry a per-element ``spread_bytes`` offset (still
      inside their page) so that caches with non-adjacent set-index bits
      (Fermi L1, §4.5) don't alias the whole ring into one set; 1536 = 3·512
      walks bits 9–13 coprime to Fermi's split set field.
    """
    phases: list[SpectrumPhase] = []
    s1 = 32 * MB

    def spread(i: np.ndarray) -> np.ndarray:
        return (i * spread_bytes) % (page_bytes // 2)

    # P5: fresh pages, stride 32 MB, inside the first active window.
    k5 = np.arange(8, dtype=np.int64)
    p5 = k5 * s1
    phases.append(SpectrumPhase("P5", p5, steady_from=0))

    # P6: fresh pages beyond the active window boundary (one per window).
    if has_window:
        p6 = active_window_bytes + np.arange(4, dtype=np.int64) * active_window_bytes
        phases.append(SpectrumPhase("P6", p6, steady_from=0))

    # P4: new lines inside already-mapped pages (TLB hit, cache miss);
    # offset > prefetch reach keeps them out of the prefetcher's shadow.
    p4 = p5 + prefetch_reach_bytes + 64 * line_bytes
    phases.append(SpectrumPhase("P4", p4, steady_from=0))

    # P2: cycle > l1tlb_entries cached lines spaced ~32 MB: pass 2+ hits the
    # data cache but misses the L1 TLB (L2 TLB still covers them).
    n2 = l1tlb_entries + 4
    k2 = np.arange(n2, dtype=np.int64)
    ring2 = k2 * s1 + spread(k2)
    p2 = np.concatenate([ring2, ring2, ring2])
    phases.append(SpectrumPhase("P2", p2, steady_from=n2))

    # P3: cycle enough cached pages that EVERY L2 TLB set is over-subscribed
    # (2·entries+1 covers unequal sets too): pass 2+ hits the data cache but
    # walks the page table.
    n3 = 2 * l2tlb_entries + 1
    k3 = np.arange(n3, dtype=np.int64)
    ring3 = k3 * page_bytes + spread(k3)
    p3 = np.concatenate([ring3, ring3, ring3])
    phases.append(SpectrumPhase("P3", p3, steady_from=n3))

    # P1: crawl one cached line (after a priming touch).
    base = p5[0]
    p1 = base + (np.arange(line_bytes // 4 * 3, dtype=np.int64) * 4) % line_bytes
    phases.append(SpectrumPhase("P1", p1, steady_from=1))
    return phases


def _tlb_entries(h: MemoryHierarchy) -> tuple[int, int]:
    """Entry counts the phase program must over-subscribe.  Derived from
    the hierarchy under test (not the paper's 16/65 defaults) so a larger
    TLB — Volta's 128-entry L2 TLB — still gets every set thrashed by the
    P2/P3 rings.  Experiment design, not leaked state: the sizes are part
    of the published device description."""
    l1 = sum(h.l1tlb.geom.way_counts) if h.l1tlb is not None else 16
    l2 = sum(h.l2tlb.geom.way_counts) if h.l2tlb is not None else 65
    return l1, l2


def measure_spectrum(make_hierarchy: Callable[[], MemoryHierarchy],
                     elem_bytes: int = 4) -> dict[str, float]:
    """Run the whole program on a fresh hierarchy; phase-median latencies."""
    h = make_hierarchy()
    h.reset()
    has_window = h.active_window_bytes is not None
    line = h.l1.geom.line_bytes if h.l1 is not None else (
        h.l2.geom.line_bytes if h.l2 is not None else 32)
    prefetch_reach = 0
    if h.l2 is not None:
        prefetch_reach = h.l2.geom.prefetch_lines * h.l2.geom.line_bytes
    l1e, l2e = _tlb_entries(h)
    phases = build_phases(page_bytes=h.page_bytes, line_bytes=line,
                          l1tlb_entries=l1e, l2tlb_entries=l2e,
                          prefetch_reach_bytes=prefetch_reach + line,
                          active_window_bytes=h.active_window_bytes or 0,
                          has_window=has_window)
    out: dict[str, float] = {}
    for ph in phases:
        idx = ph.addrs // elem_bytes
        lats, _ = h.run_chase(idx, elem_bytes=elem_bytes)
        steady = lats[ph.steady_from:]
        out[ph.pattern] = float(np.median(steady))
    return out


def spectrum_trace(make_hierarchy: Callable[[], MemoryHierarchy],
                   elem_bytes: int = 4) -> PChaseTrace:
    """Single concatenated trace (useful for plotting / cluster tests)."""
    h = make_hierarchy()
    h.reset()
    has_window = h.active_window_bytes is not None
    prefetch_reach = 0
    if h.l2 is not None:
        prefetch_reach = h.l2.geom.prefetch_lines * h.l2.geom.line_bytes
    l1e, l2e = _tlb_entries(h)
    phases = build_phases(page_bytes=h.page_bytes,
                          l1tlb_entries=l1e, l2tlb_entries=l2e,
                          prefetch_reach_bytes=prefetch_reach + 32,
                          active_window_bytes=h.active_window_bytes or 0,
                          has_window=has_window)
    addrs = np.concatenate([p.addrs for p in phases])
    idx = addrs // elem_bytes
    lats, infos = h.run_chase(idx, elem_bytes=elem_bytes)
    labels = [i.get("pattern") for i in infos]
    cfg = PChaseConfig(int(addrs.max()) + elem_bytes, 0, len(idx), elem_bytes, 0)
    return PChaseTrace(cfg, idx, lats, meta={"patterns": labels})
