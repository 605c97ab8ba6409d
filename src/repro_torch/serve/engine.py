"""Continuous-batching serving engines, dense slots and paged KV cache,
in PyTorch.

Twin of ``repro/serve/engine.py``. :class:`ServeEngine` is the dense-slot
engine: a fixed pool of ``max_slots`` cache slots, each reserving
``max_len`` worth of device memory. Requests are admitted into free
slots with a whole-prompt prefill at batch 1, and every engine tick runs
ONE batched decode step for all slots at their own positions. It is the
oracle of :class:`PagedServeEngine`, which keeps attention K/V in the
fixed-size pages of ``serve.paging``, admits prompts in page-sized chunks
interleaved with decode ticks, gates admission by free pages and
preempts the youngest request when the pool runs dry.

* Inactive slots decode garbage that the per-slot valid mask hides;
  their tokens are pinned to 0. In the paged engine their page-table
  rows point at the reserved scratch page, so their writes cannot touch
  live pages.
* Greedy sampling (argmax) keeps the engines deterministic; a sampler
  hook is provided.
* Where the JAX engines rebuild their caches (donated), these write in
  place: the dense engine copies a prefilled slot into its row of the
  batched cache, the paged engine scatters into its pool
  (``index_put_``), and each decode step writes its K/V into the same
  tensors. Page tables and the allocator stay on the host, as numpy, and
  go to the card once per step.
* Under a serving mesh (``mesh``) only the paged pool is sharded: its
  leaves are ``DTensor``s with the KV heads on ``"model"``
  (``MESH_SERVE_RULES``); parameters, activations and the host books stay
  as they are, so the tokens equal the unsharded engine's.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding
from repro_torch.serve import paging
from repro_torch.serve.paging import OutOfPages, PageAllocator

#: rule overrides for a serving mesh: ONLY the paged pool shards (KV
#: heads on "model"; pages replicated unless a caller overrides
#: "cache_pages" to "data"). Every activation rule is neutralized so all
#: compute runs on operands every rank holds whole: mesh sharding here
#: buys pool memory and per-shard gather bandwidth while token streams
#: stay bit-identical across mesh widths.
MESH_SERVE_RULES: dict = {k: None for k in sharding.DEFAULT_RULES}
MESH_SERVE_RULES["cache_kv_heads"] = "model"


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    slot: int | None = None
    prefill_pos: int = 0               # chunked prefill progress (paged)
    admit_seq: int = -1                # admission order (preemption victim)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


class ServeEngine:
    """Runs on the device of ``params`` (a :class:`T.TransformerLM`)."""

    def __init__(self, cfg: ModelConfig, params: T.TransformerLM, *,
                 max_slots: int, max_len: int,
                 sampler: Callable[[torch.Tensor], torch.Tensor] | None = None):
        if cfg.is_encoder:
            raise ValueError("encoder-only model has no decode path")
        self.cfg = cfg
        self.params = params
        self.device = params.embed.device
        self.max_slots = max_slots
        self.max_len = max_len
        self.cache = T.init_cache(cfg, max_slots, max_len, device=self.device)
        self.free: deque[int] = deque(range(max_slots))
        self.active: dict[int, Request] = {}       # slot -> request
        self.waiting: deque[Request] = deque()
        self.finished: list[Request] = []
        # per-slot position of the NEXT token to be written
        self.positions = np.zeros(max_slots, dtype=np.int32)
        self.last_tokens = np.zeros(max_slots, dtype=np.int32)
        self.sampler = sampler or (lambda logits: torch.argmax(logits, -1))
        self.steps = 0
        self.decoded_tokens = 0

    # -- queue management ---------------------------------------------------

    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError("request exceeds max_len")
        self.waiting.append(req)

    def _admit(self) -> None:
        while self.waiting and self.free:
            req = self.waiting.popleft()
            slot = self.free.popleft()
            req.slot = slot
            toks = torch.as_tensor(req.prompt[None, :], dtype=torch.long,
                                   device=self.device)
            logits, pcache = T.prefill(self.params, self.cfg,
                                       {"tokens": toks}, max_len=self.max_len)
            # copy the prefilled slot into its row of the batched cache
            # (axis 1 is the slot axis of every leaf, the SSM's included),
            # in place
            for name, leaf in self.cache.items():
                leaf[:, slot] = pcache[name][:, 0]
            tok = int(self.sampler(logits[0, -1]))
            req.generated.append(tok)
            self.last_tokens[slot] = tok
            self.positions[slot] = len(req.prompt)
            self.active[slot] = req
            self._maybe_finish(slot)

    def _maybe_finish(self, slot: int) -> None:
        req = self.active.get(slot)
        if req is not None and req.done:
            del self.active[slot]
            self.free.append(slot)
            self.finished.append(req)

    # -- the engine tick ------------------------------------------------------

    def step(self) -> int:
        """Admit + one batched decode step.  Returns #active slots."""
        self._admit()
        if not self.active:
            return 0
        toks = torch.as_tensor(self.last_tokens[:, None], dtype=torch.long,
                               device=self.device)
        idx = torch.as_tensor(self.positions, dtype=torch.long,
                              device=self.device)
        logits, self.cache = T.decode(self.params, self.cfg, self.cache,
                                      toks, idx)
        sampled = self.sampler(logits[:, 0]).cpu().numpy()
        for slot, req in list(self.active.items()):
            tok = int(sampled[slot])
            req.generated.append(tok)
            self.last_tokens[slot] = tok
            self.positions[slot] += 1
            self.decoded_tokens += 1
            self._maybe_finish(slot)
        self.steps += 1
        return len(self.active)

    def run_to_completion(self, max_steps: int = 10_000) -> list[Request]:
        while (self.waiting or self.active) and self.steps < max_steps:
            self.step()
        return sorted(self.finished, key=lambda r: r.uid)

    def stats(self) -> dict:
        return {"steps": self.steps, "decoded_tokens": self.decoded_tokens,
                "finished": len(self.finished),
                "avg_batch_occupancy":
                    self.decoded_tokens / max(1, self.steps) / self.max_slots}

    def hbm_reserved_bytes(self) -> int:
        """Attention-cache memory the dense engine reserves, occupancy-blind."""
        return (self.max_slots * self.max_len
                * paging.kv_bytes_per_token(self.cfg))


# ---------------------------------------------------------------------------
# paged engine
# ---------------------------------------------------------------------------


def _pages_split(leaf) -> bool:
    """A pool ``DTensor`` whose pages (dimension 1) are spread over ranks,
    so that no rank holds every page."""
    return any(p.is_shard(1) for p in leaf.placements)


def _pool_rows(leaf, idx: torch.Tensor) -> torch.Tensor:
    """``leaf[:, idx]`` of a pool leaf, whole on every rank. Where every
    rank holds all pages, each selects its part of those rows and only
    they cross the mesh (a collective of the mesh, once a handoff); pages
    spread over ranks gather the leaf whole."""
    if not sharding.is_dtensor(leaf):
        return leaf[:, idx]
    if _pages_split(leaf):
        return leaf.full_tensor()[:, idx]
    return sharding.gather(leaf.to_local()[:, idx], leaf.device_mesh,
                           leaf.placements)


def _write_pool_rows(leaf, idx: torch.Tensor, rows: torch.Tensor) -> None:
    """``leaf[:, idx] = rows`` in place, ``rows`` whole on every rank; a
    sharded leaf writes this rank's part of the rows into its local
    tensor, with no communication where every rank holds all pages."""
    if not sharding.is_dtensor(leaf):
        leaf[:, idx] = rows.to(leaf.device)
        return
    rows = rows.to(sharding.mesh_device(leaf.device_mesh))
    if _pages_split(leaf):
        def write(full):
            full[:, idx] = rows
        sharding.update_whole(leaf, write)
        return
    leaf.to_local()[:, idx] = sharding.local_chunk(rows, leaf.device_mesh,
                                                   leaf.placements)


class PagedServeEngine:
    """Continuous batching over a paged KV cache (see module docstring).

    ``page_len`` defaults to ``paging.choose_page_len``, sized by the cost
    model from the active profile (the published TPU v5e one when none is
    installed). ``num_pages`` defaults to dense-equivalent capacity
    (every slot can reach ``max_len``); size it by the real workload to
    realize the memory savings. ``prefill_chunk`` (a multiple of
    ``page_len``; default one page) bounds how much of a tick a long
    prompt can take, and also each request's page slack. Runs on the
    device of ``params``.

    ``mesh`` (a ``DeviceMesh``, e.g. ``launch.mesh.make_serve_mesh``)
    lays the paged pool out over the mesh's ranks, KV heads on
    ``"model"`` by ``MESH_SERVE_RULES`` updated with ``shard_rules``; each
    rank runs the engine SPMD on its own copy of ``params`` (on its own
    card), and the pages are priced per shard (``shards``).
    """

    def __init__(self, cfg: ModelConfig, params: T.TransformerLM, *,
                 max_slots: int, max_len: int, page_len: int | None = None,
                 num_pages: int | None = None,
                 prefill_chunk: int | None = None,
                 sampler: Callable[[torch.Tensor], torch.Tensor] | None = None,
                 spec=None, mesh=None, shard_rules: dict | None = None,
                 hold_after_prefill: bool = False):
        if cfg.is_encoder:
            raise ValueError("encoder-only model has no decode path")
        self.cfg = cfg
        self.params = params
        self.device = params.embed.device
        self.max_slots = max_slots
        self.max_len = max_len
        # `mesh` shards the paged pool leaves; the allocator and page
        # tables below stay on the host, unchanged
        self.mesh = mesh
        if mesh is not None:
            rules = dict(MESH_SERVE_RULES)
            rules.update(shard_rules or {})
            self._shard_ctx = sharding.ShardingCtx(mesh, rules)
        else:
            self._shard_ctx = None
        self.shards = paging.gather_shards(cfg, self._shard_ctx)
        self.page_len = page_len or paging.choose_page_len(
            cfg, spec=spec, expected_tokens=max_len, shards=self.shards)
        self.prefill_chunk = prefill_chunk or self.page_len
        if self.prefill_chunk % self.page_len:
            raise ValueError(
                f"prefill_chunk {self.prefill_chunk} must be a multiple of "
                f"page_len {self.page_len}")
        # page-table rows must cover the CHUNK-PADDED prefill frontier: a
        # prompt of max_len-1 tokens pads its last chunk past max_len when
        # prefill_chunk does not divide max_len
        frontier = -(-max_len // self.prefill_chunk) * self.prefill_chunk
        self.pages_per_seq = -(-frontier // self.page_len)
        if num_pages is None:
            num_pages = max_slots * self.pages_per_seq + paging.SCRATCH_PAGES
        self.alloc = PageAllocator(num_pages, self.page_len)
        self.cache = T.init_paged_cache(cfg, num_pages, self.page_len,
                                        max_slots, device=self.device,
                                        mesh=self._shard_ctx)
        self.page_tables = np.zeros((max_slots, self.pages_per_seq),
                                    dtype=np.int32)
        self.free_slots: deque[int] = deque(range(max_slots))
        self.waiting: deque[Request] = deque()
        self.prefilling: deque[Request] = deque()
        self.active: dict[int, Request] = {}       # slot -> decoding request
        # hold_after_prefill parks a request here the tick its prefill
        # completes instead of decoding it: the prefill-specialist mode of
        # the JAX package's tiered fleet, which drains `ready` through
        # export_pages into a decode replica
        self.hold_after_prefill = hold_after_prefill
        self.ready: deque[Request] = deque()
        self.finished: list[Request] = []
        self.cancelled: list[Request] = []
        self.positions = np.zeros(max_slots, dtype=np.int32)
        self.last_tokens = np.zeros(max_slots, dtype=np.int32)
        self.sampler = sampler or (lambda logits: torch.argmax(logits, -1))
        self.steps = 0
        self.decoded_tokens = 0
        self.preemptions = 0
        self.peak_pages = 0
        self.max_slack_tokens = 0
        self.exports = 0               # KV handoffs out
        self.imports = 0               # KV handoffs in
        self._admit_counter = 0

    def _step(self, toks: np.ndarray, start: np.ndarray, tables: np.ndarray,
              slot_ids: np.ndarray, seq_lens: np.ndarray | None):
        """One :func:`T.paged_step`; the host books go to the card here.
        The engine's sharding ctx is active around it (None pinned where
        there is no mesh, so an ambient ctx never reaches the step)."""
        dev = self.device

        def put(a):
            return torch.as_tensor(a, dtype=torch.long).to(dev)

        with sharding.use(self._shard_ctx):
            logits, self.cache = T.paged_step(
                self.params, self.cfg, self.cache, put(toks), put(start),
                put(tables), put(slot_ids),
                None if seq_lens is None else put(seq_lens))
        return logits

    # -- bookkeeping --------------------------------------------------------

    def _worst_case_pages(self, req: Request) -> int:
        """Pages a request can ever hold: the chunk-padded prefill frontier
        or the fully-decoded length, whichever is larger."""
        plen = len(req.prompt)
        pad_end = -(-plen // self.prefill_chunk) * self.prefill_chunk
        return self.alloc.pages_for(max(pad_end, plen + req.max_new_tokens))

    def submit(self, req: Request) -> None:
        plen = len(req.prompt)
        if plen + req.max_new_tokens > self.max_len:
            raise ValueError("request exceeds max_len")
        if self._worst_case_pages(req) > self.alloc.capacity:
            raise ValueError(
                f"request {req.uid} can need {self._worst_case_pages(req)} "
                f"pages; pool only has {self.alloc.capacity}")
        self.waiting.append(req)

    def _sync_table(self, req: Request) -> None:
        row = self.page_tables[req.slot]
        row[:] = 0
        pages = self.alloc.pages.get(req.uid, ())
        row[:len(pages)] = pages

    def _live(self) -> list[Request]:
        return (list(self.prefilling) + list(self.ready)
                + list(self.active.values()))

    def _drop_live(self, req: Request) -> None:
        """Remove ``req`` from whichever live structure holds it."""
        if req.slot in self.active and self.active[req.slot] is req:
            del self.active[req.slot]
        elif req in self.ready:
            self.ready.remove(req)
        else:
            self.prefilling.remove(req)

    def _preempt(self, victim: Request) -> None:
        """Copy-free rollback: pages to the free list, request re-queued
        for a full (deterministic, greedy) re-run."""
        self.alloc.release(victim.uid)
        self.page_tables[victim.slot][:] = 0
        self.free_slots.append(victim.slot)
        self._drop_live(victim)
        victim.slot = None
        victim.generated = []
        victim.prefill_pos = 0
        self.waiting.appendleft(victim)
        self.preemptions += 1

    def _ensure_pages(self, req: Request, tokens: int) -> bool:
        """Grow ``req`` to cover ``tokens``, preempting the youngest
        STRICTLY-YOUNGER request while the free list is short. Seniority
        (``admit_seq``) is assigned once and survives preemption, so the
        oldest live request is never a victim and always makes progress."""
        while True:
            try:
                if self.alloc.ensure(req.uid, tokens):
                    self._sync_table(req)
                    self.peak_pages = max(self.peak_pages,
                                          self.alloc.allocated_pages)
                return True
            except OutOfPages:
                victims = [r for r in self._live()
                           if r is not req and r.admit_seq > req.admit_seq]
                if not victims:
                    return False
                self._preempt(max(victims, key=lambda r: r.admit_seq))

    # -- admission surface ---------------------------------------------------

    def servable(self, req: Request) -> bool:
        """Can this engine EVER run ``req`` (geometry, not current load)?"""
        return (len(req.prompt) + req.max_new_tokens <= self.max_len
                and self._worst_case_pages(req) <= self.alloc.capacity)

    def can_accept(self, req: Request) -> bool:
        """Would ``req`` be admitted next tick, counting work already
        queued in ``waiting``? The predicate ``_admit`` applies (a free
        slot and a first chunk's worth of free pages), with queued
        requests charged against the slot headroom."""
        return (self.servable(req)
                and len(self.free_slots) > len(self.waiting)
                and self.alloc.free_pages
                >= self.alloc.pages_for(self.prefill_chunk))

    @property
    def saturated(self) -> bool:
        """No slot or page headroom for even a minimal new request."""
        return (len(self.free_slots) <= len(self.waiting)
                or self.alloc.free_pages
                < self.alloc.pages_for(self.prefill_chunk))

    def live_count(self) -> int:
        return len(self.prefilling) + len(self.ready) + len(self.active)

    def live_committed_tokens(self) -> int:
        """Sum of prompt + max_new over live requests."""
        return sum(len(r.prompt) + r.max_new_tokens for r in self._live())

    # -- scheduling ---------------------------------------------------------

    def _admit(self) -> None:
        """Admission gated by FREE PAGES (first chunk's worth), not by a
        whole max_len-sized slot."""
        while (self.waiting and self.free_slots
               and self.alloc.free_pages
               >= self.alloc.pages_for(self.prefill_chunk)):
            req = self.waiting.popleft()
            req.slot = self.free_slots.popleft()
            if req.admit_seq < 0:      # preempted requests keep seniority
                req.admit_seq = self._admit_counter
                self._admit_counter += 1
            req.prefill_pos = 0
            req.generated = []
            self.page_tables[req.slot][:] = 0
            self.positions[req.slot] = 0
            self.last_tokens[req.slot] = 0
            self.prefilling.append(req)

    def _prefill_tick(self) -> None:
        """One chunk of the oldest prefilling request."""
        req = self.prefilling[0]
        plen = len(req.prompt)
        start = req.prefill_pos
        # the chunk's padded tail writes garbage up to the chunk boundary,
        # so pages must cover it
        if not self._ensure_pages(req, start + self.prefill_chunk):
            return                      # stall; decode ticks will free pages
        s_real = min(self.prefill_chunk, plen - start)
        toks = np.zeros(self.prefill_chunk, dtype=np.int32)
        toks[:s_real] = req.prompt[start:start + s_real]
        logits = self._step(toks[None], np.array([start]),
                            self.page_tables[req.slot][None],
                            np.array([req.slot]), np.array([s_real]))
        req.prefill_pos += s_real
        if req.prefill_pos == plen:
            tok = int(self.sampler(logits[0, s_real - 1]))
            req.generated.append(tok)
            self.last_tokens[req.slot] = tok
            self.positions[req.slot] = plen
            self.prefilling.popleft()
            if self.hold_after_prefill and not req.done:
                self.ready.append(req)
            else:
                self.active[req.slot] = req
                self._maybe_finish(req.slot)

    def _maybe_finish(self, slot: int) -> None:
        req = self.active.get(slot)
        if req is not None and req.done:
            del self.active[slot]
            self.alloc.release(req.uid)
            self.page_tables[slot][:] = 0
            self.free_slots.append(slot)
            self.finished.append(req)

    def _decode_tick(self) -> None:
        # grow every decoding request to cover its next write position; a
        # request that cannot get a page even after preempting younger
        # work rolls itself back
        for slot in sorted(self.active):
            req = self.active.get(slot)
            if req is None:
                continue               # preempted by an earlier slot's grow
            if not self._ensure_pages(req, int(self.positions[slot]) + 1):
                self._preempt(req)
        if not self.active:
            return
        # batch rows without a DECODING request (free slots, but also slots
        # still mid-prefill) are retargeted at the scratch page / scratch
        # slot row so their garbage writes cannot corrupt live state
        mask = np.zeros(self.max_slots, dtype=bool)
        mask[list(self.active)] = True
        tables = np.where(mask[:, None], self.page_tables, 0)
        slot_ids = np.where(mask, np.arange(self.max_slots), self.max_slots)
        logits = self._step(self.last_tokens[:, None], self.positions,
                            tables, slot_ids, None)
        sampled = self.sampler(logits[:, 0]).cpu().numpy()
        for slot, req in list(self.active.items()):
            tok = int(sampled[slot])
            req.generated.append(tok)
            self.last_tokens[slot] = tok
            self.positions[slot] += 1
            self.decoded_tokens += 1
            self._maybe_finish(slot)

    def step(self) -> int:
        """Admit + at most one prefill chunk + one batched decode step.
        Returns the number of live (prefilling or decoding) requests."""
        self._admit()
        if self.prefilling:
            self._prefill_tick()
        self._decode_tick()
        self.steps += 1
        self._record_slack()
        return len(self.active) + len(self.prefilling) + len(self.ready)

    def cancel(self, uid: int) -> bool:
        """Abort a request wherever it is; frees its pages copy-free."""
        for q in (self.waiting, self.prefilling, self.ready):
            for r in q:
                if r.uid == uid:
                    q.remove(r)
                    if r.slot is not None:
                        self.alloc.release(uid)
                        self.page_tables[r.slot][:] = 0
                        self.free_slots.append(r.slot)
                        r.slot = None
                    self.cancelled.append(r)
                    return True
        for slot, r in list(self.active.items()):
            if r.uid == uid:
                del self.active[slot]
                self.alloc.release(uid)
                self.page_tables[slot][:] = 0
                self.free_slots.append(slot)
                r.slot = None
                self.cancelled.append(r)
                return True
        return False

    def run_to_completion(self, max_steps: int = 10_000) -> list[Request]:
        while (self.waiting or self.prefilling or self.ready or self.active) \
                and self.steps < max_steps:
            self.step()
        return sorted(self.finished, key=lambda r: r.uid)

    # -- failover surface ----------------------------------------------------

    def evacuate(self) -> list[Request]:
        """Roll back every LIVE request copy-free (pages to the free list,
        generation reset for a greedy re-run) and re-queue the rollbacks at
        the FRONT of ``waiting`` in admission order; seniority survives.
        Returns the rolled-back requests, oldest first."""
        victims = sorted(self._live(), key=lambda r: r.admit_seq,
                         reverse=True)
        for req in victims:            # youngest first + appendleft ==
            self.alloc.release(req.uid)  # oldest ends at the queue head
            self.page_tables[req.slot][:] = 0
            self.free_slots.append(req.slot)
            self._drop_live(req)
            req.slot = None
            req.generated = []
            req.prefill_pos = 0
            self.waiting.appendleft(req)
        return victims[::-1]

    def reset_paging(self) -> None:
        """Discard ALL paging bookkeeping: fresh allocator, zeroed page
        tables and positions. Only sound when no request is live (call
        :meth:`evacuate` first). Page contents are left alone: every
        rolled-back request re-prefills from position 0, so stale K/V is
        overwritten before it is read."""
        assert not self.active and not self.prefilling and not self.ready, \
            "reset_paging with live requests — evacuate first"
        self.alloc = PageAllocator(self.alloc.num_pages, self.page_len)
        self.page_tables[:] = 0
        self.positions[:] = 0
        self.last_tokens[:] = 0
        self.free_slots = deque(range(self.max_slots))

    # -- KV handoff surface --------------------------------------------------

    def can_import(self, tokens: int) -> bool:
        """Could a handed-off request carrying ``tokens`` of KV land here
        next tick? A free slot beyond what ``waiting`` has spoken for,
        plus pages for the WHOLE stored prefix."""
        return (len(self.free_slots) > len(self.waiting)
                and self.alloc.free_pages
                >= self.alloc.pages_for(max(1, tokens)))

    def export_pages(self, uid: int) -> tuple[Request, dict]:
        """Extract a READY request (prefill complete, held for handoff)
        and its KV as a token-major host payload; the source side is
        copy-free like :meth:`evacuate`. The payload's paged leaves are
        ``(layers, tokens, ...)`` CPU tensors, so a destination with a
        different ``page_len`` (or another mesh) can take them;
        slot-resident (SSM) leaves ride along as their one row, ``(layers,
        ...)``. A sharded pool's rows come out with all their heads (a
        collective: every rank of the mesh exports)."""
        req = next((r for r in self.ready if r.uid == uid), None)
        assert req is not None, f"uid {uid} is not ready for export"
        slot = req.slot
        tokens = int(self.positions[slot])
        pages = self.alloc.pages.get(uid, [])
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)

        def one(name, leaf):
            if name not in T.PAGED_LEAVES:
                return leaf[:, slot].cpu()
            rows = _pool_rows(leaf, idx)   # (layers, n, page_len, ...)
            flat = rows.reshape((rows.shape[0], len(pages) * self.page_len)
                                + tuple(rows.shape[3:]))
            return flat[:, :tokens].cpu()

        payload = {
            "tokens": tokens,
            "pages": len(pages),
            "page_len": self.page_len,
            "last_token": int(self.last_tokens[slot]),
            "leaves": {name: one(name, leaf)
                       for name, leaf in self.cache.items()},
        }
        self.alloc.release(uid)
        self.page_tables[slot][:] = 0
        self.free_slots.append(slot)
        self.ready.remove(req)
        req.slot = None
        self.exports += 1
        self.alloc.check_invariants()
        return req, payload

    def import_pages(self, req: Request, payload: dict) -> bool:
        """Land a handed-off request: allocate pages for its stored prefix,
        scatter the payload into this pool's geometry (in place), and put
        it straight into decode, at the back of this engine's admission
        order. Returns False, leaving the engine untouched, when capacity
        is short."""
        tokens = payload["tokens"]
        if not self.can_import(tokens):
            return False
        slot = self.free_slots.popleft()
        req.slot = slot
        req.admit_seq = self._admit_counter
        self._admit_counter += 1
        ok = self.alloc.ensure(req.uid, max(1, tokens))
        assert ok, "can_import promised pages the allocator refused"
        self._sync_table(req)
        self.peak_pages = max(self.peak_pages, self.alloc.allocated_pages)
        pages = self.alloc.pages[req.uid]
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        for name, leaf in self.cache.items():
            row = payload["leaves"][name]
            if name not in T.PAGED_LEAVES:
                leaf[:, slot] = row.to(device=self.device, dtype=leaf.dtype)
                continue
            buf = torch.zeros((row.shape[0], len(pages) * self.page_len)
                              + tuple(row.shape[2:]), dtype=leaf.dtype)
            buf[:, :tokens] = row
            _write_pool_rows(leaf, idx, buf.reshape(
                (row.shape[0], len(pages), self.page_len)
                + tuple(row.shape[2:])))
        self.positions[slot] = tokens
        self.last_tokens[slot] = payload["last_token"]
        req.prefill_pos = tokens
        self.active[slot] = req
        self.imports += 1
        self.alloc.check_invariants()
        return True

    def check_invariants(self) -> None:
        """Allocator invariants plus engine<->allocator cross-consistency
        (page tables mirror the allocator's page lists, pages cover every
        stored token, nothing dead holds pages). Cheap enough for every
        tick."""
        self.alloc.check_invariants()
        live = {r.uid: r for r in self._live()}
        assert set(self.alloc.pages) <= set(live), \
            (f"pages held by non-live uids "
             f"{sorted(set(self.alloc.pages) - set(live))}")
        for uid, req in live.items():
            pages = self.alloc.pages.get(uid, [])
            row = self.page_tables[req.slot]
            assert list(row[:len(pages)]) == pages, \
                f"uid {uid}: page table row diverges from allocator"
            assert not row[len(pages):].any(), \
                f"uid {uid}: page table row has a nonzero tail"
            assert len(pages) * self.page_len >= self._tokens_stored(req), \
                f"uid {uid}: pages do not cover stored tokens"
        for r in list(self.waiting) + self.finished + self.cancelled:
            assert r.uid not in self.alloc.pages or r.uid in live, \
                f"non-live uid {r.uid} still owns pages"

    def integrity_violations(self) -> list[str]:
        """Non-raising :meth:`check_invariants`."""
        try:
            self.check_invariants()
        except AssertionError as e:
            return [str(e) or "engine invariant violated"]
        return []

    # -- accounting ---------------------------------------------------------

    def _tokens_stored(self, req: Request) -> int:
        if req.slot is None:
            return 0
        if req.slot in self.active and self.active[req.slot] is req:
            return int(self.positions[req.slot])
        return req.prefill_pos

    def _record_slack(self) -> None:
        for req in self._live():
            held = len(self.alloc.pages.get(req.uid, ())) * self.page_len
            slack = held - self._tokens_stored(req)
            self.max_slack_tokens = max(self.max_slack_tokens, slack)

    def hbm_reserved_bytes(self) -> int:
        """Attention-cache memory held RIGHT NOW for live requests (pages
        in circulation), the number that scales with actual output."""
        return (self.alloc.allocated_pages * self.page_len
                * paging.kv_bytes_per_token(self.cfg))

    def page_table_bytes(self) -> int:
        return self.page_tables.nbytes

    def stats(self) -> dict:
        return {"steps": self.steps, "decoded_tokens": self.decoded_tokens,
                "finished": len(self.finished),
                "cancelled": len(self.cancelled),
                "preemptions": self.preemptions,
                "exports": self.exports,
                "imports": self.imports,
                "page_len": self.page_len,
                "gather_shards": self.shards,
                "num_pages": self.alloc.num_pages,
                "peak_pages": self.peak_pages,
                "max_slack_tokens": self.max_slack_tokens,
                "avg_batch_occupancy":
                    self.decoded_tokens / max(1, self.steps) / self.max_slots}
