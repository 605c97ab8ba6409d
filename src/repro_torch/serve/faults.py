"""Seeded fault injection for the serving fleet — the chaos tier.

A copy of ``repro/serve/faults.py`` for the port. Corruption touches
only host bookkeeping (the allocator's owner map and page lists, the
numpy ``page_tables`` mirror), never the torch cache.

The shape is a scripted **fault campaign** (the SPHINCS+ fault-analysis
model: seeded campaigns, classified outcomes, offline analysis of the
outcome distribution): a :class:`FaultInjector` schedules fault events
against a :class:`~repro_torch.serve.fleet.FleetEngine` run and the fleet's
deterministic event loop turns every one of them into an auditable,
replayable transition.  Three fault classes:

* **kill** — replica death mid-decode/mid-prefill.  The fleet evacuates
  the replica copy-free (zero leaked pages, asserted) and the stranded
  requests re-home through the SAME ``_migrate`` machinery that moves
  preemption rollbacks; greedy re-runs keep unaffected and re-homed
  streams byte-stable.
* **corrupt** — page-table/allocator corruption.  The injector breaks
  the replica's *bookkeeping only* (owner map, page list, page-table
  mirror) — never the bytes the jitted model computes with — and the
  fleet's per-tick integrity poll (``PagedServeEngine
  .check_invariants``) catches it before any dispatch or decode can
  consume the corrupt books, sending the replica through the
  quarantine → heal → readmit lifecycle.
* **degrade** — latency-spike degradation of a replica's profile
  (CUTHERMO's degraded-memory regime as a first-class fault, not just
  death): the spec is re-priced through ``decode_cell_cost`` so the
  router organically drains load from the sick replica; a paired
  **recover** restores the base spec.

Everything is deterministic: a scripted schedule is deterministic by
construction, and a seeded campaign (:meth:`FaultInjector.campaign`)
draws exactly one ``np.random.default_rng(seed)`` stream in tick order —
same seed, same fleet, same workload ⇒ bit-identical merged decision log
(routing decisions + fault events on one sequence), identical outcome
classification, and byte-identical token streams for unaffected
requests.  :func:`run_campaign` is the harness the tests, the
``serve_faults`` experiment and ``launch/serve.py --faults`` all share.
"""

from __future__ import annotations

import dataclasses
from collections import Counter

import numpy as np

from repro_torch.serve import fleet as fleet_mod
from repro_torch.serve.fleet import OUTCOME_CLASSES, FleetEngine  # noqa: F401

#: the injectable fault kinds (quarantine/readmit/lost are *responses*,
#: recorded by the fleet, never injected directly)
FAULT_KINDS = ("kill", "corrupt", "degrade", "recover")

#: default latency-spike severity (bandwidth and FLOPs /k, latency *k) —
#: far outside the router margin, so a spiked replica only wins a
#: decision when every healthy replica is saturated
DEGRADE_FACTOR = 4.0

#: ticks of fault exposure in a seeded campaign (faults only fire while
#: ``fleet.ticks < horizon``, so every campaign has a clean drain phase)
CAMPAIGN_HORIZON = 200

#: page-table corruption variants the injector can apply (all pure
#: bookkeeping, all caught by ``check_invariants``):
#: 0 = owner-map entry zapped, 1 = a free page aliased into a live page
#: list, 2 = nonzero tail in a live slot's page-table row
CORRUPT_VARIANTS = 3


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault.  ``replica=None`` defers target choice to
    apply time: the most-loaded eligible replica (deterministic — fleet
    state is deterministic), which is what makes seeded campaigns land
    faults where they bite without knowing the schedule a priori."""

    tick: int
    kind: str                       # one of FAULT_KINDS
    replica: int | None = None
    factor: float = DEGRADE_FACTOR  # degrade severity
    variant: int = 0                # corruption variant (mod CORRUPT_VARIANTS)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")


class FaultInjector:
    """Applies a fault schedule to a fleet, one tick at a time.

    Two modes, combinable:

    * **scripted** — pass an explicit ``schedule`` of :class:`Fault`
      entries (the campaign-file shape);
    * **seeded** — :meth:`campaign` draws faults online from one seeded
      RNG: per tick, fire with probability ``rate`` while ``ticks <
      horizon``, kind chosen uniformly from ``kinds``.  The RNG is
      consumed in strict tick order, so the draw stream — and therefore
      the whole run — is a pure function of the seed.

    ``max_kills`` bounds replica deaths (default: fleet size − 1, so a
    campaign can never kill the last replica and lose everything by
    construction).  An injector is single-use: it is consumed by the run
    it is attached to — build a fresh one (same seed/schedule) to
    replay.
    """

    def __init__(self, schedule: "tuple[Fault, ...] | list[Fault]" = (),
                 *, max_kills: int | None = None):
        self.schedule = tuple(sorted(schedule, key=lambda f: f.tick))
        self.max_kills = max_kills
        self._rng: np.random.Generator | None = None
        self.rate = 0.0
        self.kinds: tuple[str, ...] = ()
        self.horizon = CAMPAIGN_HORIZON
        self.seed: int | None = None
        self.applied: list[Fault] = []

    @classmethod
    def campaign(cls, seed: int, *, rate: float = 0.05,
                 kinds: tuple[str, ...] = ("kill", "corrupt", "degrade"),
                 horizon: int = CAMPAIGN_HORIZON,
                 max_kills: int | None = None,
                 schedule: "tuple[Fault, ...]" = ()) -> "FaultInjector":
        """A seeded campaign (optionally on top of a scripted base)."""
        inj = cls(schedule, max_kills=max_kills)
        for k in kinds:
            if k not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {k!r}")
        inj._rng = np.random.default_rng(seed)
        inj.seed = seed
        inj.rate = rate
        inj.kinds = tuple(kinds)
        inj.horizon = horizon
        return inj

    # -- per-tick application ------------------------------------------------

    def on_tick(self, fleet: FleetEngine) -> None:
        """Apply every fault due at the fleet's CURRENT tick (called by
        ``FleetEngine.step`` before dispatch)."""
        due = [f for f in self.schedule if f.tick == fleet.ticks]
        if self._rng is not None and fleet.ticks < self.horizon:
            # one draw per tick keeps the stream a function of tick count
            u = float(self._rng.random())
            if u < self.rate:
                kind = self.kinds[int(self._rng.integers(len(self.kinds)))]
                factor = float(self._rng.choice((2.0, 4.0, 8.0)))
                variant = int(self._rng.integers(CORRUPT_VARIANTS))
                due.append(Fault(fleet.ticks, kind, None, factor, variant))
        for f in due:
            self._apply(fleet, f)

    def _apply(self, fleet: FleetEngine, f: Fault) -> None:
        target = self._target(fleet, f)
        if target is None:
            fleet.record_event("skip", -1, (f.kind, "no eligible target"))
            return
        self.applied.append(dataclasses.replace(f, replica=target.index))
        if f.kind == "kill":
            fleet.kill(target.index, reason="injected")
        elif f.kind == "corrupt":
            detail = self._corrupt(target, f.variant)
            fleet.record_event("corrupt", target.index, detail)
        elif f.kind == "degrade":
            fleet.degrade(target.index, f.factor)
        elif f.kind == "recover":
            fleet.recover(target.index)

    def _target(self, fleet: FleetEngine, f: Fault):
        """Deterministic apply-time target choice (see :class:`Fault`)."""
        if f.kind == "kill":
            kills_left = ((len(fleet.replicas) - 1 - fleet.deaths)
                          if self.max_kills is None
                          else (self.max_kills - fleet.deaths))
            if kills_left <= 0:
                return None
            pool = [r for r in fleet.replicas if r.dispatchable]
        elif f.kind == "corrupt":
            # corruption needs live books to corrupt
            pool = [r for r in fleet.replicas
                    if r.dispatchable and r.engine.alloc.allocated_pages]
        elif f.kind == "degrade":
            pool = [r for r in fleet.replicas if r.dispatchable]
        else:                          # recover
            pool = [r for r in fleet.replicas
                    if r.state == fleet_mod.DEGRADED]
        if f.replica is not None:
            pool = [r for r in pool if r.index == f.replica]
        if not pool:
            return None
        # most-loaded first (live requests, then held pages), index tie-break
        return max(pool, key=lambda r: (r.engine.live_count(),
                                        r.engine.alloc.allocated_pages,
                                        -r.index))

    def _corrupt(self, replica, variant: int) -> tuple:
        """Break the replica's paging BOOKKEEPING (never page contents —
        detection fires before any token could be affected, and the
        quarantine heal re-runs everything from scratch anyway)."""
        eng = replica.engine
        alloc = eng.alloc
        uid = sorted(alloc.pages)[0]
        pages = alloc.pages[uid]
        v = variant % CORRUPT_VARIANTS
        if v == 1 and not alloc.free:
            v = 0                      # no free page to alias: fall back
        if v == 2:
            req = next((r for r in eng._live() if r.uid == uid), None)
            if req is None or len(pages) >= eng.pages_per_seq:
                v = 0                  # row full / uid not live: fall back
        if v == 0:
            alloc.owner[pages[0]] = -1           # stale owner map
        elif v == 1:
            alloc.pages[uid] = pages + [alloc.free[0]]   # aliases a free page
        else:
            eng.page_tables[req.slot][len(pages)] = pages[0]  # mirror tail
        return ("variant", v, "uid", uid)

    def stats(self) -> dict:
        by_kind = Counter(f.kind for f in self.applied)
        return {"applied": len(self.applied),
                **{f"applied_{k}": by_kind.get(k, 0) for k in FAULT_KINDS}}


# ---------------------------------------------------------------------------
# the campaign harness (shared by tests, the experiment, and the launcher)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CampaignReport:
    """Everything a campaign's offline analysis consumes — all of it
    deterministic accounting, none of it wall clock."""

    outcomes: dict[int, str]           # uid -> OUTCOME_CLASSES entry
    streams: dict[int, tuple[int, ...]]  # uid -> streamed tokens
    log: list[tuple]                   # merged decision+event log keys
    event_counts: dict[str, int]       # FaultEvent kind -> count
    stats: dict                        # FleetEngine.stats()

    def outcome_counts(self) -> dict[str, int]:
        return dict(Counter(self.outcomes.values()))

    def uids(self, outcome: str) -> list[int]:
        return sorted(u for u, c in self.outcomes.items() if c == outcome)


def run_campaign(fleet: FleetEngine, work, injector: FaultInjector | None
                 = None, *, max_ticks: int = 10_000) -> CampaignReport:
    """Stream ``work`` (``[(prompt, max_new_tokens), ...]``, uid =
    position) through a :class:`~repro_torch.serve.frontend.FleetFrontend`
    over ``fleet`` with ``injector`` attached, then classify every uid.

    A submission rejected because its capacity died mid-campaign is
    classified ``lost`` — every uid ends classified, nothing is silently
    dropped."""
    from repro_torch.serve.frontend import FleetFrontend
    if injector is not None:
        fleet.attach_injector(injector)
    front = FleetFrontend(fleet)
    rejected: list[int] = []
    for uid, (prompt, n_new) in enumerate(work):
        try:
            front.submit_blocking(prompt, n_new, uid=uid)
        except ValueError:             # unservable: capacity died
            rejected.append(uid)
    front.run(max_ticks)
    outcomes = fleet.classify()
    for uid in rejected:
        outcomes[uid] = "lost"
    return CampaignReport(
        outcomes=outcomes,
        streams={uid: tuple(h.tokens)
                 for uid, h in sorted(front.handles.items())},
        log=fleet.decision_log(),
        event_counts=dict(Counter(e.kind for e in fleet.events)),
        stats=fleet.stats())
