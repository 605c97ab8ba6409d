"""Streaming front end for the serving fleet.

A copy of ``repro/serve/frontend.py`` for the port, over the port's
:class:`~repro_torch.serve.fleet.FleetEngine`.

One *deterministic* event loop drives everything: each
:meth:`FleetFrontend.tick` runs one fleet step and then drains newly
produced tokens to per-request callbacks in uid order.  Determinism is
the design constraint, not a convenience — the N=1 fleet must reproduce
the single paged engine's token stream request-for-request (the
differential-oracle contract ``tests/test_serve_fleet.py`` pins), and a
wall-clock scheduler (asyncio timers, threads) would make routing and
stream interleaving replay-dependent.  Callers who want asynchrony wrap
``run()`` in their own executor; the loop itself never sleeps, never
polls a clock, and never consumes randomness.

Streaming across preemption: a preempted (or migrated) request is rolled
back and deterministically re-run, so its ``generated`` list is rebuilt
from scratch — the handle therefore only emits tokens *beyond* what it
has already streamed.  Greedy re-runs regenerate an identical prefix, so
the subscriber sees one continuous, replayable stream regardless of how
many times the scheduler rolled the request back.

Backpressure: the frontend bounds its submission queue.  When every
replica is page-saturated the fleet stops draining, the bound is hit and
:meth:`submit` raises :class:`Backpressure` instead of queueing unbounded
work — the caller's signal to shed load or retry after progress.

Latency accounting: the frontend owns an :class:`~repro_torch.serve.slo
.SLOTracker` and stamps every lifecycle event with the fleet's tick
counter — submission at :meth:`submit`, first token and per-token
progress in :meth:`_drain_streams`, terminal outcomes wherever they
settle.  TTFT/TPOT therefore come out in *tick units* (deterministic,
replayable), convertible to seconds with any replica's
``decode_cell_cost(...).step_s`` — see ``repro_torch.serve.slo``.

Failover: streams survive replica death and quarantine with no frontend
machinery of their own — an evacuated request is rolled back exactly
like a preempted one, so the handle silently re-earns its streamed
prefix and continues byte-stably once the request is re-homed.  The one
genuinely new terminal state is **lost**: when the fleet reaps a request
no surviving replica can ever serve, the handle is flagged ``lost``
(``on_finish`` fires, ``done`` stays False) so no submitter waits
forever on capacity that died.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.serve.engine import Request
from repro_torch.serve.fleet import FleetEngine
from repro_torch.serve.slo import SLOTracker


class Backpressure(RuntimeError):
    """The fleet queue is full (every replica page-saturated); retry
    after ticks have freed capacity."""


@dataclasses.dataclass
class StreamHandle:
    """A submitted request plus its streaming state."""

    uid: int
    request: Request
    on_token: Callable[[int, int], None] | None = None   # (uid, token)
    on_finish: Callable[["StreamHandle"], None] | None = None
    tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    cancelled: bool = False
    lost: bool = False                 # reaped by the fleet: capacity died

    @property
    def streamed(self) -> int:
        return len(self.tokens)

    @property
    def settled(self) -> bool:
        """Terminal: finished, cancelled, or lost — no more tokens."""
        return self.done or self.cancelled or self.lost


class FleetFrontend:
    """Deterministic request queue + token streamer over a FleetEngine.

    ``max_pending`` bounds the fleet-level FIFO (default: twice the
    fleet's total slots — enough to keep every replica busy through a
    full drain without ever queueing unbounded work).
    """

    def __init__(self, fleet: FleetEngine, *, max_pending: int | None = None):
        self.fleet = fleet
        total_slots = sum(r.engine.max_slots for r in fleet.replicas)
        if max_pending is None:
            max_pending = 2 * total_slots
        if max_pending <= 0:
            raise ValueError(
                f"max_pending must be positive, got {max_pending}; a "
                "non-positive bound would reject every submission")
        self.max_pending = max_pending
        self.handles: dict[int, StreamHandle] = {}
        self.slo = SLOTracker()
        self._next_uid = 0

    # -- submission ---------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *,
               on_token=None, on_finish=None,
               uid: int | None = None,
               arrival_tick: int | None = None) -> StreamHandle:
        """Queue a request; raises :class:`Backpressure` at the bound.

        ``arrival_tick`` backdates the SLO clock for callers (the trace
        driver) who retried through backpressure: TTFT then counts from
        when the request WANTED to arrive, not when the queue finally
        took it.  Defaults to the current fleet tick."""
        if len(self.fleet.pending) >= self.max_pending:
            raise Backpressure(
                f"fleet queue at its bound ({self.max_pending}); "
                f"saturated={self.fleet.saturated}")
        if uid is None:
            uid = self._next_uid
        if uid in self.handles:
            raise ValueError(f"uid {uid} already submitted")
        req = Request(uid, np.asarray(prompt, dtype=np.int32),
                      max_new_tokens)
        self.fleet.submit(req)          # may raise ValueError: unservable
        # bookkeeping only after the fleet accepted the request — a
        # rejected submission must not burn a uid or leave a handle
        self._next_uid = max(self._next_uid, uid) + 1
        handle = StreamHandle(uid, req, on_token, on_finish)
        self.handles[uid] = handle
        self.slo.on_submit(uid, self.fleet.ticks if arrival_tick is None
                           else arrival_tick)
        return handle

    def submit_blocking(self, prompt, max_new_tokens: int, *,
                        max_ticks: int = 10_000,
                        **kw) -> StreamHandle:
        """:meth:`submit`, but ride out backpressure by ticking the loop
        until the queue drains (every submitted request eventually
        finishes, so progress is guaranteed for servable work).  The one
        retry policy shared by the launcher, example and benchmark."""
        for _ in range(max_ticks):
            try:
                return self.submit(prompt, max_new_tokens, **kw)
            except Backpressure:
                self.tick()
        raise Backpressure(
            f"queue did not drain within {max_ticks} ticks")

    def cancel(self, uid: int) -> bool:
        """Abort a request wherever it lives; fires ``on_finish``.

        Guarded on ``settled``, not just done/cancelled: a LOST handle
        already fired its ``on_finish`` and may still be cancellable at
        the fleet level (its request can sit re-queued on a dead
        replica) — re-entering here would double-fire the callback."""
        handle = self.handles.get(uid)
        if handle is None or handle.settled:
            return False
        if not self.fleet.cancel(uid):
            return False
        handle.cancelled = True
        self.slo.on_finish(uid, self.fleet.ticks, "cancelled")
        if handle.on_finish:
            handle.on_finish(handle)
        return True

    @property
    def backpressure(self) -> bool:
        return (len(self.fleet.pending) >= self.max_pending
                or self.fleet.saturated)

    # -- the event loop -----------------------------------------------------

    def _drain_streams(self) -> int:
        """Emit tokens produced since the last drain, in uid order.
        Rolled-back requests re-earn their prefix silently (module doc)."""
        emitted = 0
        finished = {r.uid: r for r in self.fleet.finished()}
        for uid in sorted(self.handles):
            h = self.handles[uid]
            if h.settled:
                continue
            gen = h.request.generated
            while len(gen) > h.streamed:
                tok = gen[h.streamed]
                h.tokens.append(tok)
                emitted += 1
                self.slo.on_token(uid, self.fleet.ticks)
                if h.on_token:
                    h.on_token(uid, tok)
            if uid in finished:
                h.done = True
                self.slo.on_finish(uid, self.fleet.ticks, "finished")
                if h.on_finish:
                    h.on_finish(h)
            elif uid in self.fleet.lost:
                h.lost = True          # capacity died under this request
                self.slo.on_finish(uid, self.fleet.ticks, "lost")
                if h.on_finish:
                    h.on_finish(h)
        return emitted

    def tick(self) -> int:
        """One event-loop turn: fleet step + stream drain.  Returns the
        number of live (unsettled) handles."""
        self.fleet.step()
        self._drain_streams()
        return sum(1 for h in self.handles.values() if not h.settled)

    def run(self, max_ticks: int = 10_000) -> list[StreamHandle]:
        """Drive the loop until every handle finished or was cancelled."""
        while self.tick() and self.fleet.ticks < max_ticks:
            pass
        return [self.handles[uid] for uid in sorted(self.handles)]
