"""Per-request latency accounting in tick units: TTFT, TPOT, percentiles.

A copy of ``repro/serve/slo.py`` for the port: pure Python, nothing of
``repro``.

The serving stack's event loop is tick-deterministic (no wall clock, no
RNG — the replay guarantee every serve test pins), so latency accounting
must be too: :class:`SLOTracker` stamps request lifecycle events with the
fleet's *tick counter*, and every summary statistic below is an integer
or exact ratio of integers.  Two runs of the same seed produce
bit-identical SLO reports — which is what lets the ``serve_workload``
experiment gate on them.

Definitions (industry-standard, in ticks):

* **TTFT** (time to first token): ticks from :meth:`on_submit` to the
  tick the request's FIRST token was drained to its stream.  Queue wait
  and chunked prefill both land here — a request admitted instantly with
  a one-chunk prompt has TTFT 1 (submitted before the tick, token
  drained after it).
* **TPOT** (time per output token): mean ticks between subsequent
  tokens, ``(finish_tick - first_token_tick) / (tokens - 1)``; defined
  only for requests with ≥ 2 tokens.  In this simulator a request that
  decodes without interruption has TPOT exactly 1.0; preemption
  rollbacks and page stalls push it above 1.

Percentiles use the **nearest-rank** method (``ceil(q/100 · n)``-th of
the sorted values) — a value actually observed, no interpolation, and
therefore stable under replay comparison.

Tick units convert to seconds through the cost model, not a clock: one
decode tick is one batched decode step, so multiply by any replica's
``decode_cell_cost(...).step_s(spec)`` (:meth:`SLOReport.to_seconds`).
The same numbers priced against two different device profiles give the
dissect→deploy answer "what would THIS hardware's p99 look like" without
re-running anything.
"""

from __future__ import annotations

import dataclasses
import math

#: percentiles every summary reports (nearest-rank, deterministic)
PERCENTILES = (50, 99)

#: terminal outcome labels a tracker accepts (mirrors the frontend's
#: StreamHandle terminal states)
OUTCOMES = ("finished", "cancelled", "lost")


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the ``ceil(q/100 · n)``-th smallest value.

    Deterministic and interpolation-free — the result is always one of
    ``values`` (required for bit-identical replay comparison; numpy's
    default linear interpolation would return synthetic floats).
    """
    if not 0 < q <= 100:
        raise ValueError(f"percentile q must be in (0, 100], got {q}")
    vals = sorted(values)
    if not vals:
        raise ValueError("percentile of an empty sequence")
    rank = math.ceil(q / 100.0 * len(vals))
    return float(vals[rank - 1])


@dataclasses.dataclass
class RequestTiming:
    """One request's lifecycle timestamps, in fleet ticks."""

    uid: int
    submit_tick: int
    first_token_tick: int | None = None
    last_token_tick: int | None = None
    finish_tick: int | None = None
    tokens: int = 0
    outcome: str = "pending"

    @property
    def settled(self) -> bool:
        return self.outcome != "pending"

    @property
    def ttft_ticks(self) -> int | None:
        if self.first_token_tick is None:
            return None
        return self.first_token_tick - self.submit_tick

    @property
    def tpot_ticks(self) -> float | None:
        """Mean inter-token gap; None until a second token exists."""
        if self.tokens < 2 or self.last_token_tick is None:
            return None
        return ((self.last_token_tick - self.first_token_tick)
                / (self.tokens - 1))

    @property
    def residence_ticks(self) -> int | None:
        """Submit→settle span: the W in Little's law L = λ·W."""
        if self.finish_tick is None:
            return None
        return self.finish_tick - self.submit_tick


class SLOTracker:
    """Accumulates :class:`RequestTiming` rows from frontend callbacks.

    The :class:`~repro_torch.serve.frontend.FleetFrontend` owns one and feeds
    it from ``submit``/``_drain_streams``/``cancel``; nothing here ticks
    a clock or draws randomness, so a tracker's summary is a pure
    function of the (seeded) run that produced it.
    """

    def __init__(self):
        self.timings: dict[int, RequestTiming] = {}

    # -- event surface (called by the frontend) -----------------------------

    def on_submit(self, uid: int, tick: int) -> None:
        if uid in self.timings:
            raise ValueError(f"uid {uid} already tracked")
        self.timings[uid] = RequestTiming(uid=uid, submit_tick=tick)

    def on_token(self, uid: int, tick: int) -> None:
        t = self.timings[uid]
        if t.first_token_tick is None:
            t.first_token_tick = tick
        t.last_token_tick = tick
        t.tokens += 1

    def on_finish(self, uid: int, tick: int, outcome: str) -> None:
        if outcome not in OUTCOMES:
            raise ValueError(f"unknown outcome {outcome!r}; "
                             f"expected one of {OUTCOMES}")
        t = self.timings[uid]
        if t.settled:
            raise ValueError(f"uid {uid} already settled ({t.outcome})")
        t.finish_tick = tick
        t.outcome = outcome

    # -- derived series ------------------------------------------------------

    def finished(self) -> list[RequestTiming]:
        return [t for t in self.timings.values() if t.outcome == "finished"]

    def ttfts(self) -> list[int]:
        return [t.ttft_ticks for t in self.finished()
                if t.ttft_ticks is not None]

    def tpots(self) -> list[float]:
        return [t.tpot_ticks for t in self.finished()
                if t.tpot_ticks is not None]

    def residences(self) -> list[int]:
        return [t.residence_ticks for t in self.finished()]

    def report(self) -> "SLOReport":
        """Fold the rows into a deterministic summary (tick units)."""
        counts = {o: 0 for o in OUTCOMES + ("pending",)}
        for t in self.timings.values():
            counts[t.outcome] += 1
        fin = self.finished()
        tokens = sum(t.tokens for t in fin)
        makespan = (max(t.finish_tick for t in fin)
                    - min(t.submit_tick for t in fin)) if fin else 0
        ttfts, tpots, res = self.ttfts(), self.tpots(), self.residences()

        def pcts(vals) -> dict[str, float]:
            if not vals:
                return {f"p{q}": float("nan") for q in PERCENTILES}
            return {f"p{q}": percentile(vals, q) for q in PERCENTILES}

        return SLOReport(
            requests=len(self.timings),
            outcome_counts=counts,
            tokens=tokens,
            makespan_ticks=makespan,
            ttft=pcts(ttfts),
            tpot=pcts(tpots),
            ttft_mean=(sum(ttfts) / len(ttfts)) if ttfts else float("nan"),
            tpot_mean=(sum(tpots) / len(tpots)) if tpots else float("nan"),
            mean_residence_ticks=(sum(res) / len(res)) if res
            else float("nan"),
            # Little's law as an accounting identity: time-averaged live
            # requests over the makespan — λ·W with λ = n/makespan and
            # W = Σ residence / n, so it holds EXACTLY by construction;
            # the planner's claim is predicting W, validated against this
            mean_concurrency=(sum(res) / makespan) if makespan
            else float("nan"),
        )


@dataclasses.dataclass(frozen=True)
class SLOReport:
    """One run's latency summary — every field deterministic, tick units."""

    requests: int
    outcome_counts: dict[str, int]
    tokens: int
    makespan_ticks: int
    ttft: dict[str, float]             # {"p50": ..., "p99": ...}
    tpot: dict[str, float]
    ttft_mean: float
    tpot_mean: float
    mean_residence_ticks: float
    mean_concurrency: float            # Σ residence / makespan (= λ·W)

    def key(self) -> tuple:
        """Compact identity for bit-identical replay comparison (NaNs
        compare unequal, so empty-series fields are stringified)."""
        return (self.requests, tuple(sorted(self.outcome_counts.items())),
                self.tokens, self.makespan_ticks,
                tuple(sorted(self.ttft.items())),
                tuple(sorted(self.tpot.items())),
                repr(self.ttft_mean), repr(self.tpot_mean),
                repr(self.mean_residence_ticks),
                repr(self.mean_concurrency))

    def to_seconds(self, step_s: float) -> dict[str, float]:
        """Price the tick-unit stats on a device: one tick = one batched
        decode step = ``decode_cell_cost(...).step_s(spec)`` seconds."""
        out = {"step_s": step_s,
               "makespan_s": self.makespan_ticks * step_s,
               "ttft_mean_s": self.ttft_mean * step_s,
               "tpot_mean_s": self.tpot_mean * step_s}
        out.update({f"ttft_{k}_s": v * step_s for k, v in self.ttft.items()})
        out.update({f"tpot_{k}_s": v * step_s for k, v in self.tpot.items()})
        if self.makespan_ticks:
            out["tokens_per_s"] = self.tokens / (self.makespan_ticks * step_s)
        return out

    def lines(self) -> list[str]:
        """Human-readable block (the launcher prints it)."""
        c = self.outcome_counts
        return [
            f"requests={self.requests} "
            f"(finished={c['finished']} cancelled={c['cancelled']} "
            f"lost={c['lost']} pending={c['pending']}), "
            f"tokens={self.tokens} over {self.makespan_ticks} ticks",
            f"TTFT ticks: p50={self.ttft['p50']:g} p99={self.ttft['p99']:g} "
            f"mean={self.ttft_mean:.2f}",
            f"TPOT ticks: p50={self.tpot['p50']:g} p99={self.tpot['p99']:g} "
            f"mean={self.tpot_mean:.3f}",
            f"mean residence={self.mean_residence_ticks:.1f} ticks, "
            f"mean concurrency={self.mean_concurrency:.2f} "
            "(= arrival rate x residence; Little's law)",
        ]
