"""Paged KV-cache allocation: fixed-size pages, free-list, page tables.

A copy of ``repro/serve/paging.py`` for the port: numpy and the
standard library only, nothing of ``repro``.

The serving engine's cache is no longer a dense ``(max_slots, max_len)``
block: attention K/V live in a shared pool of ``num_pages`` fixed-size
pages and every request holds an ordered list of physical pages covering
exactly the tokens it has actually produced.  The allocator is plain
Python/numpy bookkeeping — the jitted model only ever sees the dense page
pool plus an ``(slots, pages_per_seq)`` int32 page table.

Page length is *derived*, not hard-coded: :func:`choose_page_len` prices
each candidate with the repo's own dissection laws —

* **Little's law** (paper §5.1, ``core.littles_law``): a page is one
  contiguous DMA row of the gather; rows much smaller than the
  latency-hiding in-flight quantum waste bandwidth on transfer setup, so
  the gather-overhead term falls as ``setup/(setup + row_bytes)``.
* **Fragmentation**: a live request wastes half a page on average, so the
  capacity-waste term grows linearly in ``page_len``.
* **Bank-conflict row model** (paper §6.2, ``core.bankconflict``): the
  page row stride must keep the VMEM lane-serialization degree at 1,
  i.e. rows must be whole (sublanes × lanes) tiles; candidates that are
  not are penalized by their predicted serialization degree.

Physical page 0 is a permanently reserved *scratch* page: inactive batch
slots in the jitted decode step write their garbage K/V there, so they can
never corrupt a live request's pages (the paged analogue of the dense
engine's "inactive slots decode garbage" trade).
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.core import bankconflict, littles_law, profile
from repro_torch.core.costmodel import (  # noqa: F401  (re-exported for serve)
    kv_bytes_per_token, kv_bytes_per_token_layer,
)
from repro_torch.models.config import ModelConfig

#: physical page ids below this are never handed out (page 0 = scratch)
SCRATCH_PAGES = 1

#: outstanding DMA descriptors assumed by the gather-overhead term: with D
#: transfers in flight, each must carry required_inflight/D bytes to keep
#: the HBM pipe busy (Little's law applied per-transfer)
GATHER_OUTSTANDING = 16


class OutOfPages(RuntimeError):
    """Raised by ``alloc`` when the free list cannot cover a request."""


class PageAllocator:
    """Free-list page allocator with per-request page lists.

    All-or-nothing ``alloc``; ``release`` is copy-free (pages go straight
    back on the free list).  ``check_invariants`` is cheap enough to call
    every engine tick — the soak test does.
    """

    def __init__(self, num_pages: int, page_len: int):
        if num_pages <= SCRATCH_PAGES:
            raise ValueError(f"need > {SCRATCH_PAGES} pages, got {num_pages}")
        if page_len < 1:
            raise ValueError(f"page_len must be >= 1, got {page_len}")
        self.num_pages = num_pages
        self.page_len = page_len
        self.free: deque[int] = deque(range(SCRATCH_PAGES, num_pages))
        self.pages: dict[int, list[int]] = {}       # uid -> physical pages
        # -2 scratch, -1 free, else owning uid
        self.owner = np.full(num_pages, -1, dtype=np.int64)
        self.owner[:SCRATCH_PAGES] = -2

    # -- capacity ----------------------------------------------------------

    @property
    def capacity(self) -> int:
        """Allocatable pages (total minus scratch)."""
        return self.num_pages - SCRATCH_PAGES

    @property
    def free_pages(self) -> int:
        return len(self.free)

    @property
    def allocated_pages(self) -> int:
        return sum(len(p) for p in self.pages.values())

    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_len)

    # -- alloc / release ---------------------------------------------------

    def alloc(self, uid: int, n: int = 1) -> list[int]:
        """Append ``n`` pages to ``uid``'s page list (all-or-nothing)."""
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        if n == 0:
            # no phantom bookkeeping: a uid that owns nothing must not
            # appear in `pages` (check_invariants rejects empty lists)
            return []
        if n > len(self.free):
            raise OutOfPages(f"uid {uid}: need {n} pages, {len(self.free)} free")
        got = [self.free.popleft() for _ in range(n)]
        for p in got:
            self.owner[p] = uid
        self.pages.setdefault(uid, []).extend(got)
        return got

    def ensure(self, uid: int, tokens: int) -> int:
        """Grow ``uid``'s page list to cover ``tokens``; returns #new pages."""
        need = self.pages_for(tokens) - len(self.pages.get(uid, ()))
        if need > 0:
            self.alloc(uid, need)
            return need
        return 0

    def release(self, uid: int) -> int:
        """Free every page held by ``uid`` (copy-free). Returns the count."""
        pages = self.pages.pop(uid, [])
        for p in pages:
            self.owner[p] = -1
            self.free.append(p)
        return len(pages)

    # -- invariants --------------------------------------------------------

    def violations(self) -> list[str]:
        """Non-raising :meth:`check_invariants`: the corruption-DETECTION
        hook the fleet's chaos tier polls.  Returns the first violated
        invariant's message (empty list when the books are clean) so a
        fault campaign can quarantine a corrupted replica instead of
        crashing the fleet."""
        try:
            self.check_invariants()
        except AssertionError as e:
            return [str(e) or "allocator invariant violated"]
        return []

    def check_invariants(self) -> None:
        """No leaks, no double ownership, accounting closed."""
        freeset = set(self.free)
        assert len(freeset) == len(self.free), "free list has duplicates"
        owned: set[int] = set()
        for uid, pages in self.pages.items():
            assert pages, f"uid {uid} has an empty page list"
            pset = set(pages)
            assert len(pset) == len(pages), f"uid {uid} holds a page twice"
            assert not (pset & owned), f"uid {uid} shares a page"
            assert not (pset & freeset), f"uid {uid} holds a freed page"
            for p in pages:
                assert self.owner[p] == uid, f"owner map stale for page {p}"
            owned |= pset
        assert all(p >= SCRATCH_PAGES for p in owned | freeset), \
            "scratch page leaked into circulation"
        assert len(owned) + len(freeset) == self.capacity, \
            (f"leak: {len(owned)} owned + {len(freeset)} free "
             f"!= {self.capacity} allocatable")
        assert int((self.owner == -1).sum()) == len(freeset)


# ---------------------------------------------------------------------------
# page-length sizing from the dissection laws
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PageLenTerm:
    """Scoring terms for one candidate page length (all dimensionless)."""

    page_len: int
    row_bytes: int              # contiguous gather row per layer PER SHARD
    gather_frac: float          # bandwidth lost to transfer setup
    frag_frac: float            # capacity lost to the half-page tail
    table_frac: float           # capacity spent on page-table entries
    conflict_degree: int        # VMEM lane-serialization of the row stride
    score: float
    shards: int = 1             # mesh partitions the heads dim splits into


def page_len_rationale(cfg: ModelConfig, *, spec=None,
                       expected_tokens: int = 256,
                       candidates: tuple[int, ...] = (8, 16, 32, 64, 128, 256),
                       shards: int = 1,
                       ) -> list[PageLenTerm]:
    """Price every candidate page length with the paper's laws.

    ``expected_tokens`` is the typical total sequence length served
    (prompt + generation); the fragmentation and page-table terms are
    fractions of that working set.  ``spec`` resolves through
    ``repro.core.profile`` — a dissected profile artifact changes the
    Little's-law setup term and the lane geometry here, not constants.

    ``shards`` is the number of mesh partitions the pool's KV-heads dim
    is split into: each shard gathers only ``1/shards`` of a page row,
    against its OWN partition's full bandwidth and latency (per-partition,
    not aggregate, is the right anchor — arXiv:1804.06826).  Thinner
    per-shard rows leave more of the in-flight quantum uncovered, so wider
    meshes push the argmin toward LONGER pages.  ``shards=1`` is exactly
    the unsharded pricing.
    """
    spec = profile.resolve_spec(spec)
    full_bpt = kv_bytes_per_token_layer(cfg)
    if full_bpt == 0:             # attention-free: paging is table-only
        full_bpt = 1
    bpt = max(1, full_bpt // max(1, shards))
    setup = littles_law.tpu_required_inflight_bytes(spec) / GATHER_OUTSTANDING
    out = []
    for pl in candidates:
        row = pl * bpt
        gather = setup / (setup + row)
        frag = (pl / 2) / expected_tokens
        # one int32 entry per page, priced against the UNSHARDED row: the
        # page table is host-side bookkeeping and is never partitioned,
        # so its overhead must not inflate with the shard count
        table = 4.0 / (pl * full_bpt)
        # bank-conflict row model: a page row that is a whole number of
        # lane rows (lanes x 4 B) gathers as contiguous tiles (degree 1);
        # a sub-tile row makes one vector read straddle pages, i.e. a
        # strided access with stride = row words — the same lane/row
        # counting as the paper's shared-memory model
        if row % (spec.lanes * 4) == 0:
            degree = 1
        else:
            degree = bankconflict.tpu_conflict_degree(max(1, row // 4),
                                                      lanes=spec.lanes,
                                                      sublanes=spec.sublanes)
        penalty = max(0.0, (degree - 1) / spec.sublanes)
        out.append(PageLenTerm(pl, row, round(gather, 4), round(frag, 4),
                               round(table, 6), degree,
                               round(gather + frag + table + penalty, 4),
                               max(1, shards)))
    return out


def choose_page_len(cfg: ModelConfig, *, spec=None,
                    expected_tokens: int = 256, shards: int = 1) -> int:
    """The argmin of :func:`page_len_rationale` (ties -> smaller page)."""
    terms = page_len_rationale(cfg, spec=spec,
                               expected_tokens=expected_tokens,
                               shards=shards)
    best = min(terms, key=lambda t: (t.score, t.page_len))
    return best.page_len


def gather_shards(cfg: ModelConfig, ctx) -> int:
    """Partitions the paged gather actually runs in under ``ctx``: the
    mesh-axis size of the ``cache_kv_heads`` rule when it divides the
    model's KV-head count, else 1 (the GQA replication fallback, and
    MLA's rank-3 compressed leaves which never shard heads)."""
    if ctx is None:
        return 1
    if cfg.use_mla or cfg.num_kv_heads <= 0:
        return 1
    size = ctx.axis_size(ctx.mesh_axes("cache_kv_heads"))
    return size if size > 1 and cfg.num_kv_heads % size == 0 else 1
