"""Profile-aware multi-replica serving fleet.

A copy of ``repro/serve/fleet.py`` for the port. Each replica runs the
port's :class:`~repro_torch.serve.engine.PagedServeEngine` on the device
of ``params``; every replica shares that one parameter object, so the
weights are never copied per replica. ``mesh`` makes every replica a
device slice whose paged pool is mesh-sharded (``shard_rules`` override
``MESH_SERVE_RULES``); routing stays on the host, unchanged.

:class:`FleetEngine` runs N :class:`~repro_torch.serve.engine.PagedServeEngine`
replicas — each bound to its OWN resolved device profile, so mixed
GTX980 / TeslaV100 / tpu_v5e fleets are first-class — behind a router
that prices admission with the same measure-then-deploy machinery the
single-engine path already consumes:

* **step cost** (:meth:`~repro_torch.core.costmodel.CellCost.step_s`): a fresh
  ``decode_cell_cost`` is priced against each candidate replica's spec
  for the load it would carry *after* admitting the request.  One
  CellCost per (replica, decision) keeps the pricing correctly scoped —
  a mixed fleet must never trip ``SpecMixWarning``, which exists to catch
  ONE plan straddling two profiles, not N plans each on their own.
* **free-page headroom**: among cost-equivalent replicas the router
  prefers the one with the most pages left after the request's first
  chunk — the fleet analogue of admission-by-free-pages.
* **Little's-law inflight bound**: a replica whose live sequence count
  already covers its latency-hiding quantum
  (``required_inflight_bytes / gather row``) gains nothing from more
  concurrency, so the router penalizes overage — the paper's occupancy
  law applied to request placement instead of warp placement.

Every decision is appended to a :class:`RouteDecision` log and the whole
scheduler is deterministic (no RNG, no wall clock, index tie-breaks), so
a fleet run REPLAYS bit-identically: the ``serve_fleet`` experiment gates
on it.  The router never chooses a replica whose predicted step cost
exceeds the best candidate's by more than its own ``margin`` — that
invariant is checked from the decision log, not trusted.

With one replica the fleet degenerates exactly to the single paged
engine: dispatch applies the engine's own admission predicate
(:meth:`~repro_torch.serve.engine.PagedServeEngine.can_accept`), so the same
requests are admitted on the same ticks and the token stream is
request-for-request identical — the dense/paged single-engine path stays
the differential oracle.

**Chaos tier** (``repro_torch.serve.faults`` drives it): every replica carries
a lifecycle state — ``healthy``/``degraded``/``quarantined``/``dead`` —
and the router only ever dispatches to *dispatchable* (healthy or
degraded) replicas.  :meth:`FleetEngine.kill` evacuates a replica
copy-free (zero leaked pages, stranded requests re-homed through the
same ``_migrate`` machinery that moves preemption rollbacks);
corruption detected by ``PagedServeEngine.check_invariants`` sends a
replica through the :meth:`quarantine` → heal → :meth:`readmit`
lifecycle; :meth:`degrade` swaps in a latency-spiked spec so
``decode_cell_cost`` re-prices the replica and the router organically
drains load from it.  Every lifecycle transition is recorded as a
:class:`FaultEvent` sharing one fleet-global sequence with the routing
decisions, so :meth:`decision_log` stays bit-identical under replay of
ANY fault schedule — the deterministic event loop's payoff.

**Tiered fleets** (``repro_torch.serve.tiers`` defines the policy): with a
non-symmetric :class:`~repro_torch.serve.tiers.TierPlan` the router splits
into two stages.  Stage 1 places fresh admissions (and re-prefill
migrations) on *prefill-tier* replicas, priced per replica with
``prefill_cell_cost`` — the FLOP + bandwidth cost of the prompt the
request brings (chunking only spreads that work over ticks, so the
whole prompt is the right admission quantum).  A prefill-specialist
replica runs with ``hold_after_prefill``: the tick a prompt completes,
the request parks in the engine's ``ready`` queue instead of decoding.
Stage 2 then routes a **KV handoff**: ``decode_cell_cost`` at the
destination's load *plus* the paged-page transfer priced by
``min(src, dst)`` measured global-memory bandwidth
(:func:`repro_torch.serve.tiers.handoff_seconds`).  The handoff occupies
:func:`~repro_torch.serve.tiers.handoff_ticks` fleet ticks in transit —
during which the stream's tokens are withheld, so the transfer lands in
TTFT instead of vanishing between tiers — and the pages arrive via
``PagedServeEngine.export_pages``/``import_pages`` (copy-free on the
source, allocator-checked on both ends).  Both stage decisions AND the
handoff transfer event ride the same fleet-global sequence, so the
two-stage log still replays bit-for-bit, and ``margin_violations()``
audits both stages with one rule.  A symmetric plan (or ``tiers=None``)
keeps every stage a no-op: the fleet reproduces the single-stage router
token-for-token on the same tick schedule — the tiered link of the
dense→paged→fleet oracle chain.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Sequence

from repro_torch.core import littles_law, profile
from repro_torch.core.costmodel import (ParallelismPlan, decode_cell_cost,
                                  prefill_cell_cost)
from repro_torch.core.devices import TpuSpec
from repro_torch.models.config import ModelConfig
from repro_torch.serve import paging, tiers as tiering
from repro_torch.serve.engine import PagedServeEngine, Request
from repro_torch.serve.tiers import TierPlan

#: default routing margin: a replica within 10% of the cheapest predicted
#: step cost is cost-equivalent and competes on headroom instead
ROUTER_MARGIN = 0.10

#: replica lifecycle states (the chaos tier's vocabulary)
HEALTHY = "healthy"          # serving normally
DEGRADED = "degraded"        # serving, but priced with a spiked spec
QUARANTINED = "quarantined"  # corruption detected: healed, timed readmit
DEAD = "dead"                # replica lost: permanent for the run

#: states the router may dispatch to
DISPATCHABLE_STATES = (HEALTHY, DEGRADED)

#: fleet ticks a quarantined replica sits out before readmission
QUARANTINE_TICKS = 8

#: terminal outcome classes a fault campaign assigns to every request
OUTCOME_CLASSES = ("completed", "migrated", "requeued", "lost", "cancelled")

_SINGLE_CHIP = ParallelismPlan(dp=1, tp=1, fsdp=False)


def resolve_fleet_profile(entry) -> "TpuSpec | None":
    """One replica-profile entry → the TpuSpec it is priced with.

    Accepts ``None`` (the process default), a :class:`TpuSpec`, a
    :class:`~repro_torch.core.profile.DeviceProfile` (any kind — GPU profiles
    price through their measured :meth:`serving_spec` view), or a string:
    an artifact path / device name under ``experiments/profiles/`` if one
    exists, else the published profile for that registered device.
    """
    if entry is None or isinstance(entry, TpuSpec):
        return entry
    if isinstance(entry, profile.DeviceProfile):
        return entry.serving_spec()
    if isinstance(entry, str):
        import os

        from repro_torch.profile import load_profile, path_for, published_profile
        if entry.endswith(".json"):
            return load_profile(entry).serving_spec()
        if os.path.exists(path_for(entry)):
            return load_profile(entry).serving_spec()
        return published_profile(entry).serving_spec()
    raise TypeError(f"cannot resolve fleet profile from {type(entry)!r}")


@dataclasses.dataclass(frozen=True)
class RouteScore:
    """One candidate replica's pricing at one decision point."""

    replica: int
    step_cost_s: float          # total priced cost (incl. handoff_s)
    free_pages_after: int       # page headroom after the first chunk
    inflight_overage: int       # live+1 beyond the Little's-law bound
    within_margin: bool
    handoff_s: float = 0.0      # KV-transfer share ("handoff" stage only)


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    """One routing decision, replayable and auditable."""

    seq: int                    # decision counter (fleet-global)
    tick: int
    uid: int
    kind: str                   # "admit" | "migrate" | "handoff"
    scores: tuple[RouteScore, ...]
    chosen: int                 # replica index

    def key(self) -> tuple:
        """Compact identity for bit-identical replay comparison."""
        return (self.seq, self.tick, self.uid, self.kind, self.chosen,
                tuple((s.replica, round(s.step_cost_s, 15),
                       s.free_pages_after, s.inflight_overage,
                       round(s.handoff_s, 15))
                      for s in self.scores))


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One fault or lifecycle transition, recorded in the decision log.

    ``seq`` shares the fleet-global sequence counter with
    :class:`RouteDecision`, so the merged log totally orders faults
    against routing — replay compares the interleaving, not just each
    stream separately.  ``kind`` is one of ``kill``, ``corrupt``,
    ``degrade``, ``recover``, ``quarantine``, ``readmit``, ``lost`` or
    ``skip`` (an injector fault that found no eligible target); the
    tiered fleet adds ``handoff`` (a KV transfer left its source) and
    ``handoff_abort`` (the destination was gone or full at arrival) —
    not faults, but transfers belong in the same total order so the
    two-stage log replays as ONE interleaving.
    """

    seq: int
    tick: int
    kind: str
    replica: int                # -1 for fleet-level events (e.g. "lost")
    detail: tuple = ()

    def key(self) -> tuple:
        """Compact identity for bit-identical replay comparison."""
        return (self.seq, self.tick, f"fault:{self.kind}", self.replica,
                self.detail)


@dataclasses.dataclass
class _Transit:
    """One KV handoff in flight between tiers.

    While in transit the request is resident NOWHERE — the source freed
    its pages at export, the destination allocates at arrival — and its
    token stream (``held``) is withheld from the frontend so the
    transfer's ticks land in TTFT.
    """

    req: Request
    payload: dict
    src: int
    dst: int
    arrive_tick: int
    held: list[int]                    # generated tokens withheld in flight


class FleetReplica:
    """One engine + the spec it is priced and page-sized with."""

    def __init__(self, index: int, cfg: ModelConfig, params, *,
                 spec: TpuSpec | None, max_slots: int, max_len: int,
                 page_len: int | None, num_pages: int | None,
                 prefill_chunk: int | None, sampler,
                 mesh=None, shard_rules: dict | None = None,
                 prefill_tier: bool = True, decode_tier: bool = True):
        self.index = index
        # resolve ONCE: every subsequent pricing of this replica uses the
        # same pinned spec object (never the mutable process default)
        self.spec = profile.resolve_spec(spec)
        # one replica = one device slice: its paged pool is laid out over
        # `mesh` (KV heads on "model"), its page_len priced per shard
        self.mesh = mesh
        # tier membership (symmetric fleets leave both True); a
        # prefill-SPECIALIST parks completed prompts for handoff instead
        # of decoding them — that is the only engine-level difference
        self.prefill_tier = prefill_tier
        self.decode_tier = decode_tier
        self.engine = PagedServeEngine(
            cfg, params, max_slots=max_slots, max_len=max_len,
            page_len=page_len, num_pages=num_pages,
            prefill_chunk=prefill_chunk, sampler=sampler, spec=self.spec,
            mesh=mesh, shard_rules=shard_rules,
            hold_after_prefill=prefill_tier and not decode_tier)
        self.cfg = cfg
        self._row_bytes = (self.engine.page_len
                           * max(1, paging.kv_bytes_per_token_layer(cfg)))
        # Little's law: sequences needed so their gather rows cover the
        # in-flight quantum; past this, concurrency adds latency not BW
        self.inflight_bound = max(1, round(
            littles_law.tpu_required_inflight_bytes(self.spec)
            / self._row_bytes))
        # chaos-tier lifecycle: the spec a degraded replica recovers to,
        # the state the router filters on, and the readmission deadline
        self.base_spec = self.spec
        self.state = HEALTHY
        self.quarantined_until = -1

    @property
    def dispatchable(self) -> bool:
        """May the router place work here?  Healthy or degraded only —
        quarantined and dead replicas never receive dispatches (a fleet
        invariant, asserted by ``check_invariants``)."""
        return self.state in DISPATCHABLE_STATES

    def rebind_spec(self, spec: "TpuSpec") -> None:
        """Re-price this replica (latency-spike degradation/recovery):
        every subsequent routing decision uses the new spec, and the
        Little's-law inflight bound is re-derived from it.  Page
        geometry is NOT re-derived — pages are already handed out."""
        self.spec = spec
        self.inflight_bound = max(1, round(
            littles_law.tpu_required_inflight_bytes(spec)
            / self._row_bytes))

    @property
    def name(self) -> str:
        return f"r{self.index}:{self.spec.name}"

    def score(self, req: Request, kind: str = "admit",
              handoff_s: float = 0.0) -> RouteScore:
        """Price placing ``req`` onto this replica, against its OWN
        spec.  A fresh CellCost per call — pricing is scoped to one
        (replica, decision), which is why a mixed fleet never warns.

        Admission and migration place *prefill* work, so they are priced
        with ``prefill_cell_cost`` over the whole prompt the request
        brings (the FLOP + bandwidth cost chunking merely spreads over
        ticks) — a bandwidth-rich replica wins the prefill-dominated
        phase it is actually good at, instead of being handicapped by a
        decode-shaped estimate.  The ``handoff`` stage places *decode*
        work: ``decode_cell_cost`` at the load this replica would carry,
        plus the caller-computed KV-transfer term ``handoff_s`` (priced
        by ``min(src, dst)`` bandwidth) so a cheap decoder behind an
        expensive transfer does not look free."""
        eng = self.engine
        live = eng.live_count() + len(eng.waiting)
        if kind == "handoff":
            tokens = (eng.live_committed_tokens()
                      + sum(len(r.prompt) + r.max_new_tokens
                            for r in eng.waiting)
                      + len(req.prompt) + req.max_new_tokens)
            seq = max(1, tokens // (live + 1))
            cell = decode_cell_cost(self.cfg, global_batch=live + 1,
                                    seq=seq, plan=_SINGLE_CHIP,
                                    name=f"fleet/{self.name}")
        else:                          # "admit" | "migrate": prefill work
            cell = prefill_cell_cost(self.cfg, global_batch=1,
                                     seq=max(1, len(req.prompt)),
                                     plan=_SINGLE_CHIP,
                                     name=f"fleet/{self.name}")
        chunk_pages = eng.alloc.pages_for(eng.prefill_chunk)
        return RouteScore(
            replica=self.index,
            step_cost_s=cell.step_s(self.spec) + handoff_s,
            free_pages_after=eng.alloc.free_pages - chunk_pages,
            inflight_overage=max(0, live + 1 - self.inflight_bound),
            within_margin=False,       # filled in by the router
            handoff_s=handoff_s)

    @property
    def tier(self) -> str:
        if self.prefill_tier and self.decode_tier:
            return "both"
        return "prefill" if self.prefill_tier else "decode"

    def stats(self) -> dict:
        s = self.engine.stats()
        s["replica"] = self.name
        s["spec"] = self.spec.name
        s["inflight_bound"] = self.inflight_bound
        s["state"] = self.state
        s["tier"] = self.tier
        return s


class FleetEngine:
    """N paged replicas behind the profile-aware router (module doc).

    ``profiles`` gives one entry per replica (see
    :func:`resolve_fleet_profile`); ``replicas`` alone builds a
    homogeneous fleet on the active profile.  ``num_pages`` may be a
    sequence (one pool size per replica) to model unequal HBM headroom.
    ``mesh`` makes every replica a device slice: each engine's paged pool
    is mesh-sharded (``launch.mesh.make_serve_mesh`` builds the shape the
    ``--mesh-shape`` flag names); routing stays on the host, unchanged.
    Requests enter a fleet-level FIFO and are dispatched head-of-line:
    the router either places ``pending[0]`` or leaves it queued until a
    replica frees capacity — FIFO admission is what makes an N=1 fleet
    reproduce the single engine's schedule exactly.
    """

    def __init__(self, cfg: ModelConfig, params, *,
                 max_slots: int, max_len: int,
                 replicas: int | None = None,
                 profiles: Sequence | None = None,
                 page_len: int | None = None,
                 num_pages: "int | Sequence[int] | None" = None,
                 prefill_chunk: int | None = None,
                 sampler: Callable | None = None,
                 margin: float = ROUTER_MARGIN,
                 migration: bool = True,
                 quarantine_ticks: int = QUARANTINE_TICKS,
                 mesh=None, shard_rules: dict | None = None,
                 tiers: "TierPlan | str | None" = None):
        if profiles is None:
            profiles = [None] * (replicas or 1)
        elif replicas is not None and replicas != len(profiles):
            raise ValueError(
                f"replicas={replicas} but {len(profiles)} profiles given")
        if not profiles:
            raise ValueError("a fleet needs at least one replica")
        if isinstance(num_pages, (list, tuple)):
            if len(num_pages) != len(profiles):
                raise ValueError(
                    f"{len(num_pages)} num_pages for {len(profiles)} "
                    "replicas")
            pools = list(num_pages)
        else:
            pools = [num_pages] * len(profiles)
        self.cfg = cfg
        self.margin = margin
        self.migration = migration
        # specs resolve BEFORE replicas exist: the "auto" tier plan ranks
        # them by measured bandwidth/latency (repro_torch.serve.tiers)
        specs = [profile.resolve_spec(resolve_fleet_profile(p))
                 for p in profiles]
        self.tier_plan = tiering.resolve_tiers(tiers, len(profiles), specs)
        self.tiered = self.tier_plan.tiered
        self.replicas = [
            FleetReplica(i, cfg, params,
                         spec=specs[i],
                         max_slots=max_slots, max_len=max_len,
                         page_len=page_len, num_pages=pools[i],
                         prefill_chunk=prefill_chunk, sampler=sampler,
                         mesh=mesh, shard_rules=shard_rules,
                         prefill_tier=i in self.tier_plan.prefill,
                         decode_tier=i in self.tier_plan.decode)
            for i in range(len(profiles))]
        self.pending: deque[Request] = deque()
        self.decisions: list[RouteDecision] = []
        self.events: list[FaultEvent] = []
        self.injector = None           # attach_injector (repro_torch.serve.faults)
        self.quarantine_ticks = quarantine_ticks
        self.lost: dict[int, Request] = {}
        self.ticks = 0
        self.migrations = 0
        self.rejected = 0
        self.handoffs = 0
        self.handoff_aborts = 0
        self._transit: list[_Transit] = []     # KV handoffs in flight
        self.deaths = 0
        self.quarantines = 0
        self.readmits = 0
        self.degrades = 0
        self._seqno = 0                # decisions + events share one order
        self._submitted: set[int] = set()
        self._cancelled: set[int] = set()
        self._homes: dict[int, set[int]] = {}   # uid -> replicas it ran on
        self._fault_hit: set[int] = set()       # uids evacuated by a fault

    # -- event log ----------------------------------------------------------

    def _next_seq(self) -> int:
        self._seqno += 1
        return self._seqno - 1

    def record_event(self, kind: str, replica: int,
                     detail: tuple = ()) -> FaultEvent:
        """Append a :class:`FaultEvent` to the fleet-global log (shared
        sequence with routing decisions, so replay compares the full
        interleaving)."""
        ev = FaultEvent(seq=self._next_seq(), tick=self.ticks, kind=kind,
                        replica=replica, detail=detail)
        self.events.append(ev)
        return ev

    # -- routing ------------------------------------------------------------

    def _route(self, req: Request, kind: str,
               exclude: frozenset[int] = frozenset(),
               src: "FleetReplica | None" = None,
               ) -> FleetReplica | None:
        """Score every dispatchable replica that can take ``req`` now;
        pick within the cost margin by (inflight overage, page headroom,
        index).  Quarantined and dead replicas are never candidates.

        ``kind`` selects the routing stage: ``admit``/``migrate`` place
        prefill work on prefill-tier replicas, ``handoff`` places decode
        work on decode-tier replicas (``src`` is then the exporting
        replica, whose measured bandwidth caps the transfer rate).  In a
        symmetric fleet every replica sits in both tiers and the filter
        is a no-op."""
        if kind == "handoff":
            assert src is not None
            tokens = len(req.prompt)
            n_bytes = tiering.handoff_bytes(
                self.cfg, len(src.engine.alloc.pages.get(req.uid, ())),
                src.engine.page_len)
            candidates = [r for r in self.replicas
                          if r.index not in exclude
                          and r.dispatchable
                          and r.decode_tier
                          and r.engine.can_import(tokens)]
            scores = {r.index: r.score(req, kind,
                                       handoff_s=tiering.handoff_seconds(
                                           n_bytes, src.spec, r.spec))
                      for r in candidates}
        else:
            candidates = [r for r in self.replicas
                          if r.index not in exclude
                          and r.dispatchable
                          and r.prefill_tier
                          and r.engine.can_accept(req)]
            scores = {r.index: r.score(req, kind) for r in candidates}
        if not candidates:
            return None
        best = min(s.step_cost_s for s in scores.values())
        cut = best * (1.0 + self.margin)
        scores = {i: dataclasses.replace(s, within_margin=s.step_cost_s <= cut)
                  for i, s in scores.items()}
        within = [r for r in candidates if scores[r.index].within_margin]
        chosen = min(within, key=lambda r: (scores[r.index].inflight_overage,
                                            -scores[r.index].free_pages_after,
                                            r.index))
        self.decisions.append(RouteDecision(
            seq=self._next_seq(), tick=self.ticks, uid=req.uid,
            kind=kind,
            scores=tuple(scores[i] for i in sorted(scores)),
            chosen=chosen.index))
        return chosen

    def _place(self, req: Request, replica: FleetReplica) -> None:
        self._homes.setdefault(req.uid, set()).add(replica.index)
        replica.engine.submit(req)

    def _dispatch(self) -> None:
        while self.pending:
            replica = self._route(self.pending[0], "admit")
            if replica is None:
                return                 # head-of-line blocks: FIFO fairness
            self._place(self.pending.popleft(), replica)

    def _migrate(self) -> None:
        """Re-route preempted requests stranded behind a saturated
        replica.  A request sitting in a replica's waiting queue after
        its tick is a preemption rollback (fresh dispatches were just
        admitted); if its home replica cannot re-admit it now but
        another can, move it — seniority is engine-local, so the mover
        re-enters the target's admission order at the back.  For a
        non-dispatchable (quarantined/dead) home the re-admission check
        is skipped entirely: failover re-homing rides the SAME machinery
        as preemption migration."""
        for r in self.replicas:
            eng = r.engine
            chunk_pages = eng.alloc.pages_for(eng.prefill_chunk)
            for pos, req in enumerate(list(eng.waiting)):
                if req.admit_seq < 0 and r.dispatchable:
                    continue
                # the home engine re-admits it next tick iff the replica
                # is serving AND a slot is free for its queue position
                # AND a chunk's worth of pages survived the preemption
                # scramble (can_accept would wrongly charge the request
                # against itself here)
                if (r.dispatchable
                        and pos < len(eng.free_slots)
                        and eng.alloc.free_pages >= chunk_pages):
                    continue
                target = self._route(req, "migrate",
                                     exclude=frozenset((r.index,)))
                if target is None:
                    continue
                eng.waiting.remove(req)
                req.admit_seq = -1
                self._place(req, target)
                self.migrations += 1

    # -- KV handoff (the tiered fleet's second routing stage) ---------------

    def _collect_handoffs(self) -> None:
        """Stage 2: route every request whose prefill just completed on a
        prefill-specialist replica to a decode-tier replica, export its
        pages (copy-free on the source) and put the transfer in flight.
        An unroutable request (decode tier saturated or down) simply
        stays ``ready`` — it holds its pages and retries next tick, so
        nothing is dropped and nothing decodes out of tier."""
        for r in self.replicas:
            if not (self.tiered and r.engine.hold_after_prefill
                    and r.dispatchable):
                continue
            for req in list(r.engine.ready):
                target = self._route(req, "handoff", src=r)
                if target is None:
                    continue
                chosen = next(s for s in self.decisions[-1].scores
                              if s.replica == target.index)
                ticks = tiering.handoff_ticks(
                    chosen.handoff_s, chosen.step_cost_s - chosen.handoff_s)
                req, payload = r.engine.export_pages(req.uid)
                # withhold the stream while the pages are in flight: the
                # first token only reaches the frontend after arrival,
                # so the transfer's ticks show up in TTFT
                held, req.generated = req.generated, []
                self._transit.append(_Transit(
                    req=req, payload=payload, src=r.index,
                    dst=target.index, arrive_tick=self.ticks + ticks,
                    held=held))
                self.handoffs += 1
                self.record_event(
                    "handoff", r.index,
                    (req.uid, target.index, payload["pages"], ticks))

    def _abort_handoff(self, t: _Transit, why: str) -> None:
        """Arrival failed (destination died/quarantined or its capacity
        evaporated): roll the request back to the fleet queue for a full
        re-prefill, exactly like a preemption rollback — greedy re-runs
        regenerate the withheld prefix, so the stream stays byte-stable."""
        t.req.generated = []
        t.req.prefill_pos = 0
        t.req.admit_seq = -1           # seniority is engine-local: reset
        self.pending.appendleft(t.req)
        self.handoff_aborts += 1
        self.record_event("handoff_abort", t.dst, (t.req.uid, why))

    def _arrive_handoffs(self) -> None:
        """Land every transfer whose transit time has elapsed: allocate
        on the destination, scatter the pages, release the withheld
        tokens.  A destination that was killed/quarantined mid-flight
        counts as a fault hit (the request classifies requeued/migrated,
        never silently completed)."""
        due = [t for t in self._transit if t.arrive_tick <= self.ticks]
        for t in due:
            self._transit.remove(t)
            dst = self.replicas[t.dst]
            if not dst.dispatchable:
                self._fault_hit.add(t.req.uid)
                self._abort_handoff(t, f"destination {dst.state}")
                continue
            t.req.generated = t.held
            if not dst.engine.import_pages(t.req, t.payload):
                self._abort_handoff(t, "destination out of capacity")

    # -- fault lifecycle (driven by repro_torch.serve.faults, or directly) --------

    def attach_injector(self, injector) -> None:
        """Bind a :class:`repro_torch.serve.faults.FaultInjector`: its due
        faults are applied at the START of every tick, and corruption
        detection runs right after (so corrupt books are quarantined
        before any dispatch or decode consumes them)."""
        self.injector = injector

    def kill(self, index: int, *, reason: str = "fault") -> list[Request]:
        """Replica death: evacuate every live request copy-free (ZERO
        leaked pages — asserted), leave the rollbacks in the dead
        replica's waiting queue for ``_migrate`` to re-home, and mark
        the replica permanently dead for this run."""
        r = self.replicas[index]
        if r.state == DEAD:
            return []
        moved = r.engine.evacuate()
        assert r.engine.alloc.allocated_pages == 0, \
            f"replica {index} leaked pages across death"
        self._fault_hit.update(q.uid for q in moved)
        r.state = DEAD
        self.deaths += 1
        self.record_event("kill", index,
                          (reason, len(moved), len(r.engine.waiting)))
        return moved

    def quarantine(self, index: int, *, ticks: int | None = None,
                   reason: str = "fault") -> list[Request]:
        """Corruption response: evacuate, rebuild the paging books from
        scratch (``reset_paging`` — clean by construction), and sit the
        replica out for ``ticks`` fleet ticks.  Stranded requests either
        migrate away (``_migrate`` skips the home-readmission check for
        a non-dispatchable home) or re-earn their place here after
        :meth:`readmit`."""
        r = self.replicas[index]
        if r.state in (DEAD, QUARANTINED):
            return []
        ticks = self.quarantine_ticks if ticks is None else ticks
        moved = r.engine.evacuate()
        r.engine.reset_paging()
        self._fault_hit.update(q.uid for q in moved)
        r.state = QUARANTINED
        r.quarantined_until = self.ticks + max(1, ticks)
        self.quarantines += 1
        self.record_event("quarantine", index,
                          (reason, len(moved), r.quarantined_until))
        return moved

    def readmit(self, index: int) -> None:
        """Quarantine over: the replica returns healthy, on its base
        spec (a degradation does not survive the heal)."""
        r = self.replicas[index]
        if r.state != QUARANTINED:
            return
        r.state = HEALTHY
        r.quarantined_until = -1
        r.rebind_spec(r.base_spec)
        self.readmits += 1
        self.record_event("readmit", index)

    def degrade(self, index: int, factor: float = 4.0) -> None:
        """Latency-spike a replica's profile: bandwidth and FLOPs divided
        by ``factor``, HBM latency multiplied by it.  Nothing but the
        PRICING changes — the router sees the spike through
        ``decode_cell_cost(...).step_s`` and organically drains load
        from the sick replica; tokens are never touched."""
        r = self.replicas[index]
        if not r.dispatchable:
            return
        spiked = dataclasses.replace(
            r.spec,
            peak_bf16_flops=r.spec.peak_bf16_flops / factor,
            hbm_bytes_per_s=r.spec.hbm_bytes_per_s / factor,
            hbm_latency_s=r.spec.hbm_latency_s * factor)
        r.rebind_spec(spiked)
        if r.state == HEALTHY:
            r.state = DEGRADED
        self.degrades += 1
        self.record_event("degrade", index, (round(factor, 6),))

    def recover(self, index: int) -> None:
        """Undo :meth:`degrade`: back to the base spec and healthy."""
        r = self.replicas[index]
        if r.state != DEGRADED:
            return
        r.rebind_spec(r.base_spec)
        r.state = HEALTHY
        self.record_event("recover", index)

    def _detect(self) -> None:
        """Poll every serving replica's integrity (allocator + page-table
        mirrors); a violation quarantines the replica before dispatch or
        decode can consume the corrupt books.  Only runs under an
        attached injector — outside fault campaigns a violated invariant
        must CRASH (it is a bug, not chaos)."""
        for r in self.replicas:
            if not r.dispatchable:
                continue
            bad = r.engine.integrity_violations()
            if bad:
                self.quarantine(r.index, reason=bad[0][:80])

    def _readmit_due(self) -> None:
        for r in self.replicas:
            if r.state == QUARANTINED and self.ticks >= r.quarantined_until:
                self.readmit(r.index)

    def _reap_lost(self) -> None:
        """Classify as LOST any request no non-dead replica can ever
        serve (capacity died with its replicas).  Quarantined capacity
        counts as coming back, so its work waits instead of dying.  In
        a tiered fleet a queued request needs a PREFILL-tier home, and a
        post-prefill request (ready or in transit) needs a decode-tier
        home — if that whole tier died, its work is reaped, pages
        released, nothing leaks."""
        alive = [r for r in self.replicas if r.state != DEAD]
        prefill_alive = [r for r in alive if r.prefill_tier]
        decode_alive = [r for r in alive if r.decode_tier]

        def doomed(req: Request) -> bool:
            return not any(a.engine.servable(req) for a in prefill_alive)

        for r in self.replicas:
            if r.state != DEAD:
                continue
            for req in [q for q in r.engine.waiting if doomed(q)]:
                r.engine.waiting.remove(req)
                self._lose(req, f"stranded on dead r{r.index}")
        for req in [q for q in self.pending if doomed(q)]:
            self.pending.remove(req)
            self._lose(req, "no capable replica left")
        if self.tiered and not decode_alive:
            for t in list(self._transit):
                self._transit.remove(t)
                self._lose(t.req, "decode tier died in flight")
            for r in self.replicas:
                if not r.dispatchable:
                    continue
                eng = r.engine
                for req in list(eng.ready):
                    eng.alloc.release(req.uid)
                    eng.page_tables[req.slot][:] = 0
                    eng.free_slots.append(req.slot)
                    eng.ready.remove(req)
                    req.slot = None
                    self._lose(req, "decode tier died")

    def _lose(self, req: Request, why: str) -> None:
        self.lost[req.uid] = req
        self.record_event("lost", -1, (req.uid, why))

    # -- public surface ------------------------------------------------------

    def submit(self, req: Request) -> None:
        alive = [r for r in self.replicas if r.state != DEAD]
        ok = any(r.engine.servable(req) for r in alive if r.prefill_tier)
        if ok and self.tiered and req.max_new_tokens > 1:
            # a decoding request also needs a decode-tier home it fits
            ok = any(r.engine.servable(req) for r in alive if r.decode_tier)
        if not ok:
            self.rejected += 1
            raise ValueError(
                f"request {req.uid} (prompt {len(req.prompt)} + "
                f"{req.max_new_tokens} new) fits no replica in the fleet")
        self._submitted.add(req.uid)
        self.pending.append(req)

    def cancel(self, uid: int) -> bool:
        for req in self.pending:
            if req.uid == uid:
                self.pending.remove(req)
                self._cancelled.add(uid)
                return True
        for t in self._transit:        # cancelled mid-handoff: the pages
            if t.req.uid == uid:       # are in flight, resident nowhere
                self._transit.remove(t)
                self._cancelled.add(uid)
                return True
        if any(r.engine.cancel(uid) for r in self.replicas):
            self._cancelled.add(uid)
            return True
        return False

    @property
    def saturated(self) -> bool:
        """Every SERVING replica is page/slot-saturated (non-dispatchable
        replicas count as saturated) — the backpressure signal the
        streaming front end surfaces to submitters."""
        return all(not r.dispatchable or r.engine.saturated
                   for r in self.replicas)

    def live(self) -> int:
        return (len(self.pending) + len(self._transit)
                + sum(r.engine.live_count() + len(r.engine.waiting)
                      for r in self.replicas))

    def step(self) -> int:
        """One fleet tick: inject due faults + detect corruption, lift
        due quarantines, land due KV handoffs, dispatch, tick every
        SERVING replica (index order), export newly-ready prefills to
        the decode tier, migrate stranded rollbacks, reap doomed
        requests.  Returns live requests.  With no injector, no faults
        and a symmetric tier plan every added stage is a no-op, so an
        N=1 or single-tier fleet still reproduces the single paged
        engine tick-for-tick."""
        if self.injector is not None:
            self.injector.on_tick(self)
            self._detect()
        self._readmit_due()
        if self._transit:
            self._arrive_handoffs()
        self._dispatch()
        for r in self.replicas:
            if r.dispatchable:
                r.engine.step()
        if self.tiered:
            self._collect_handoffs()
        if self.migration and len(self.replicas) > 1:
            self._migrate()
        if self.deaths:
            self._reap_lost()
        self.ticks += 1
        return self.live()

    def run_to_completion(self, max_ticks: int = 10_000) -> list[Request]:
        while self.live() and self.ticks < max_ticks:
            self.step()
        return self.finished()

    def finished(self) -> list[Request]:
        out = [q for r in self.replicas for q in r.engine.finished]
        return sorted(out, key=lambda q: q.uid)

    def check_invariants(self) -> None:
        """Fleet-wide invariants, cheap enough for every soak tick:
        every replica's engine/allocator books are clean, no uid is
        owned by two replicas, and no quarantined or dead replica holds
        live work (i.e. ever received a dispatch while down)."""
        owner: dict[int, int] = {}
        for r in self.replicas:
            r.engine.check_invariants()
            for req in list(r.engine.waiting) + r.engine._live():
                prev = owner.setdefault(req.uid, r.index)
                assert prev == r.index, \
                    f"uid {req.uid} owned by replicas r{prev} and r{r.index}"
            if not r.dispatchable:
                assert r.engine.live_count() == 0, \
                    f"{r.state} replica r{r.index} has live work"
                assert r.engine.alloc.allocated_pages == 0, \
                    f"{r.state} replica r{r.index} still holds pages"
        for req in self.pending:
            assert req.uid not in owner, \
                f"uid {req.uid} both pending and placed on r{owner[req.uid]}"
        assert not set(self.lost) & set(owner), "lost uid still owned"
        # tiered invariants: an in-flight handoff is resident NOWHERE (its
        # source freed the pages at export, the destination has not yet
        # allocated — a stream can never sit in two tiers' page tables),
        # and a prefill specialist never decodes
        for t in self._transit:
            assert t.req.uid not in owner, \
                f"in-transit uid {t.req.uid} still owned by a replica"
            holders = [r.index for r in self.replicas
                       if t.req.uid in r.engine.alloc.pages]
            assert not holders, \
                f"in-transit uid {t.req.uid} holds pages on {holders}"
        for r in self.replicas:
            if r.engine.hold_after_prefill:
                assert not r.engine.active, \
                    f"prefill specialist r{r.index} is decoding"

    def classify(self) -> dict[int, str]:
        """Terminal outcome class per submitted uid (``OUTCOME_CLASSES``):

        * ``completed`` — finished, never touched by a fault;
        * ``migrated`` — finished after running on more than one replica
          (failover re-homing or preemption migration);
        * ``requeued`` — finished on its home replica after a fault
          rolled it back (kill/quarantine evacuation);
        * ``cancelled`` — cancelled by the caller;
        * ``lost`` — everything else: reaped as unservable, or still
          unfinished when the campaign was classified.  Every uid ends
          in exactly one class — nothing is silently dropped.
        """
        finished = {q.uid for r in self.replicas for q in r.engine.finished}
        cancelled = self._cancelled | {
            q.uid for r in self.replicas for q in r.engine.cancelled}
        out: dict[int, str] = {}
        for uid in sorted(self._submitted):
            if uid in finished:
                if len(self._homes.get(uid, ())) > 1:
                    out[uid] = "migrated"
                elif uid in self._fault_hit:
                    out[uid] = "requeued"
                else:
                    out[uid] = "completed"
            elif uid in cancelled:
                out[uid] = "cancelled"
            else:
                out[uid] = "lost"
        return out

    def decision_log(self) -> list[tuple]:
        """Routing decisions AND fault events, merged on the shared
        fleet-global sequence — the replay artifact."""
        merged = ([d.key() for d in self.decisions]
                  + [e.key() for e in self.events])
        return sorted(merged, key=lambda k: k[0])

    def stats(self) -> dict:
        per = [r.stats() for r in self.replicas]
        return {
            "ticks": self.ticks,
            "replicas": len(self.replicas),
            "tiers": self.tier_plan.describe(),
            "tiered": self.tiered,
            "decisions": len(self.decisions),
            "migrations": self.migrations,
            "handoffs": self.handoffs,
            "handoff_aborts": self.handoff_aborts,
            "in_transit": len(self._transit),
            "rejected": self.rejected,
            "deaths": self.deaths,
            "quarantines": self.quarantines,
            "readmits": self.readmits,
            "degrades": self.degrades,
            "lost": len(self.lost),
            "fault_events": len(self.events),
            "margin_violations": len(self.margin_violations()),
            "states": tuple(r.state for r in self.replicas),
            "preemptions": sum(s["preemptions"] for s in per),
            "decoded_tokens": sum(s["decoded_tokens"] for s in per),
            "finished": sum(s["finished"] for s in per),
            "max_slack_tokens": max(s["max_slack_tokens"] for s in per),
            "peak_pages": sum(s["peak_pages"] for s in per),
            "pages_leaked": sum(r.engine.alloc.allocated_pages
                                for r in self.replicas),
            "per_replica": per,
        }

    def margin_violations(self) -> list[RouteDecision]:
        """Decisions that picked a replica beyond the margin of the best
        candidate — the router contract, audited from its own log."""
        out = []
        for d in self.decisions:
            best = min(s.step_cost_s for s in d.scores)
            chosen = next(s for s in d.scores if s.replica == d.chosen)
            if chosen.step_cost_s > best * (1.0 + self.margin) * (1 + 1e-12):
                out.append(d)
        return out
