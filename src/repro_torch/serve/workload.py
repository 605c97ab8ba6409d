"""Seeded workload generation: realistic traffic for the serving tiers.

A copy of ``repro/serve/workload.py`` for the port: numpy and the
standard library, nothing of ``repro``.

Every serving oracle so far ran on hand-built request lists; this module
generates the traffic those oracles are pointed at — and keeps the
repo's determinism discipline while doing it.  A :class:`WorkloadSpec`
names a **scenario** (per-request prompt/output length distributions), an
**arrival process** (when requests show up) and a seed; :func:`
generate_trace` turns it into a :class:`Trace` by consuming exactly one
``np.random.default_rng(seed)`` stream *in tick order* — the same
discipline as the chaos tier's seeded campaigns, so a whole trace is a
pure function of its spec and replays bit-identically
(:meth:`Trace.fingerprint` is the comparison artifact).

Scenarios (length distributions are gamma-shaped fractions of the
engine's ``max_len``, so one spec scales from micro test configs to real
pools):

* ``chat``  — short prompts, mid-length replies; the interactive staple.
* ``rag``   — retrieval-augmented: LONG prompts (the stuffed context),
  short grounded answers.  Prefill-heavy: stresses chunked admission.
* ``agent`` — many-turn tool loops: each arrival is a *session* of
  several short correlated requests a few ticks apart.
* ``batch`` — offline summarize: mid prompts, LONG outputs.
  Decode-heavy: stresses page growth and preemption.

Arrival processes (per tick, all seeded):

* ``poisson`` — memoryless baseline, ``k ~ Poisson(rate)``.
* ``bursty``  — two-state on/off modulation (flash crowds): bursts
  multiply the rate by ``BURST_FACTOR`` while they last.
* ``diurnal`` — sinusoidal day curve with ``DIURNAL_PERIOD``-tick days:
  peak traffic ``(1 + DIURNAL_AMPLITUDE)`` × the nominal rate.

:func:`replay_trace` drives a :class:`~repro_torch.serve.frontend
.FleetFrontend` through a trace on its arrival schedule (backpressured
arrivals re-queue FIFO and their TTFT keeps counting from the ORIGINAL
arrival tick — queueing you caused is latency you must report), leaving
per-request TTFT/TPOT in the frontend's :class:`~repro_torch.serve.slo
.SLOTracker`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from collections import deque

import numpy as np

#: burst multiplier while the bursty process is in its ON state
BURST_FACTOR = 6.0
#: per-tick probability of entering / leaving a burst
BURST_ON_P = 0.06
BURST_OFF_P = 0.25

#: one synthetic "day" for the diurnal curve, in ticks
DIURNAL_PERIOD = 48
#: peak-to-nominal rate swing of the diurnal curve
DIURNAL_AMPLITUDE = 0.8

#: widest gap (ticks, exclusive) between an agent session's turns
TURN_GAP_MAX = 4


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Per-request length distributions, as fractions of ``max_len``.

    Lengths are drawn ``round(Gamma(shape, mean/shape))`` — mean
    ``frac × max_len``, coefficient of variation ``1/sqrt(shape)`` — and
    clipped so every request fits the engine (``prompt + output ≤
    max_len``, both ≥ 1).  ``turns_mean > 1`` makes each arrival a
    session of several requests (the agent loop).
    """

    name: str
    prompt_frac: float
    prompt_shape: float
    output_frac: float
    output_shape: float
    turns_mean: float = 1.0
    description: str = ""

    def mean_prompt(self, max_len: int) -> float:
        return max(1.0, self.prompt_frac * max_len)

    def mean_output(self, max_len: int) -> float:
        return max(1.0, self.output_frac * max_len)


SCENARIOS: dict[str, Scenario] = {
    "chat": Scenario("chat", prompt_frac=0.15, prompt_shape=2.0,
                     output_frac=0.30, output_shape=2.0,
                     description="short prompts, mid replies "
                                 "(interactive)"),
    "rag": Scenario("rag", prompt_frac=0.55, prompt_shape=6.0,
                    output_frac=0.12, output_shape=3.0,
                    description="long stuffed-context prompts, short "
                                "grounded answers (prefill-heavy)"),
    "agent": Scenario("agent", prompt_frac=0.20, prompt_shape=3.0,
                      output_frac=0.12, output_shape=3.0, turns_mean=4.0,
                      description="many-turn tool loops: sessions of "
                                  "short correlated requests"),
    "batch": Scenario("batch", prompt_frac=0.30, prompt_shape=3.0,
                      output_frac=0.50, output_shape=2.0,
                      description="offline summarize: long outputs "
                                  "(decode/page-growth-heavy)"),
}

ARRIVALS = ("poisson", "bursty", "diurnal")


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Everything a trace is a function of."""

    scenario: str = "chat"
    arrival: str = "poisson"
    rate: float = 0.5              # nominal arrivals per tick
    horizon: int = 64              # ticks of arrivals (tail may run longer)
    seed: int = 0
    max_len: int = 48              # engine geometry the lengths fit in
    vocab_size: int = 64

    def __post_init__(self):
        if self.scenario not in SCENARIOS:
            raise ValueError(f"unknown scenario {self.scenario!r}; "
                             f"one of {sorted(SCENARIOS)}")
        if self.arrival not in ARRIVALS:
            raise ValueError(f"unknown arrival {self.arrival!r}; "
                             f"one of {ARRIVALS}")
        if self.rate <= 0:
            raise ValueError(f"rate must be positive, got {self.rate}")
        if self.horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {self.horizon}")
        if self.max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {self.max_len}")


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One arrival: uid order == arrival order (FIFO-stable)."""

    uid: int
    tick: int
    prompt: np.ndarray             # (plen,) int32
    max_new_tokens: int
    session: int = 0               # arrival group (agent turns share one)


@dataclasses.dataclass(frozen=True)
class Trace:
    spec: WorkloadSpec
    requests: tuple[TraceRequest, ...]

    def fingerprint(self) -> str:
        """Content digest for bit-identical replay comparison."""
        h = hashlib.sha256(repr(self.spec).encode())
        for r in self.requests:
            h.update(f"{r.uid},{r.tick},{r.max_new_tokens},{r.session};"
                     .encode())
            h.update(np.ascontiguousarray(r.prompt).tobytes())
        return h.hexdigest()

    def stats(self) -> dict:
        """The characterization the capacity planner consumes: measured
        (not nominal) arrival rate and mean lengths, so bursty and
        session-expanded traces are priced by what actually arrives."""
        n = len(self.requests)
        span = max(self.spec.horizon,
                   (max(r.tick for r in self.requests) + 1) if n else 1)
        return {
            "requests": n,
            "span_ticks": span,
            "arrival_per_tick": n / span,
            "mean_prompt": (sum(len(r.prompt) for r in self.requests) / n)
            if n else 0.0,
            "mean_new": (sum(r.max_new_tokens for r in self.requests) / n)
            if n else 0.0,
            "total_tokens": sum(len(r.prompt) + r.max_new_tokens
                                for r in self.requests),
            "sessions": len({r.session for r in self.requests}),
        }


def _draw_len(rng: np.random.Generator, mean: float, shape: float,
              lo: int, hi: int) -> int:
    """One gamma length draw, rounded and clipped to [lo, hi]."""
    val = int(round(float(rng.gamma(shape, mean / shape))))
    return max(lo, min(hi, val))


def _arrival_count(rng: np.random.Generator, spec: WorkloadSpec,
                   tick: int, state: dict) -> int:
    """Arrivals due this tick.  Each branch consumes a FIXED per-tick
    draw pattern, so the stream position is a function of the tick
    index alone — the property that makes traces replayable."""
    if spec.arrival == "poisson":
        return int(rng.poisson(spec.rate))
    if spec.arrival == "bursty":
        u = float(rng.random())
        if state["on"]:
            state["on"] = u >= BURST_OFF_P
        else:
            state["on"] = u < BURST_ON_P
        rate = spec.rate * (BURST_FACTOR if state["on"] else 1.0)
        return int(rng.poisson(rate))
    # diurnal: one sinusoidal "day" every DIURNAL_PERIOD ticks
    rate = spec.rate * (1.0 + DIURNAL_AMPLITUDE
                        * math.sin(2.0 * math.pi * tick / DIURNAL_PERIOD))
    return int(rng.poisson(max(0.0, rate)))


def generate_trace(spec: WorkloadSpec) -> Trace:
    """One seeded RNG stream, consumed strictly in tick order (then in
    arrival order within a tick, then turn order within a session) —
    the whole trace is a pure function of ``spec``."""
    sc = SCENARIOS[spec.scenario]
    rng = np.random.default_rng(spec.seed)
    state = {"on": False}
    births: list[tuple[int, int, np.ndarray, int, int]] = []
    seq = 0
    session = 0
    for tick in range(spec.horizon):
        for _ in range(_arrival_count(rng, spec, tick, state)):
            turns = (1 if sc.turns_mean <= 1.0
                     else 1 + int(rng.poisson(sc.turns_mean - 1.0)))
            at = tick
            for turn in range(turns):
                plen = _draw_len(rng, sc.mean_prompt(spec.max_len),
                                 sc.prompt_shape, 1, spec.max_len - 1)
                n_new = _draw_len(rng, sc.mean_output(spec.max_len),
                                  sc.output_shape, 1, spec.max_len - plen)
                prompt = rng.integers(spec.vocab_size,
                                      size=plen).astype(np.int32)
                births.append((at, seq, prompt, n_new, session))
                seq += 1
                if turn + 1 < turns:   # next turn lands a few ticks out
                    at += 1 + int(rng.integers(TURN_GAP_MAX))
            session += 1
    births.sort(key=lambda b: (b[0], b[1]))
    return Trace(spec, tuple(
        TraceRequest(uid, at, prompt, n_new, sess)
        for uid, (at, _, prompt, n_new, sess) in enumerate(births)))


# ---------------------------------------------------------------------------
# driving a frontend through a trace on its arrival schedule
# ---------------------------------------------------------------------------


def replay_trace(front, trace: Trace, *, max_ticks: int = 10_000,
                 on_token=None) -> dict[int, object]:
    """Submit every trace request at its arrival tick and run the loop
    dry.  Backpressured arrivals re-queue FIFO and retry each tick;
    their TTFT keeps counting from the ORIGINAL arrival tick (the
    ``arrival_tick`` pass-through below), so shed-and-retry latency is
    reported, not hidden.  Returns ``{uid: StreamHandle}``; the latency
    rows land in ``front.slo``.
    """
    from repro_torch.serve.frontend import Backpressure
    pending = deque(trace.requests)
    deferred: deque[TraceRequest] = deque()
    handles: dict[int, object] = {}

    def try_submit(tr: TraceRequest) -> bool:
        try:
            handles[tr.uid] = front.submit(
                tr.prompt, tr.max_new_tokens, uid=tr.uid,
                on_token=on_token, arrival_tick=tr.tick)
            return True
        except Backpressure:
            return False

    while True:
        now = front.fleet.ticks
        while deferred and try_submit(deferred[0]):
            deferred.popleft()
        if not deferred:               # FIFO: nothing jumps the retry queue
            while pending and pending[0].tick <= now:
                if try_submit(pending[0]):
                    pending.popleft()
                else:
                    deferred.append(pending.popleft())
                    break
        live = sum(1 for h in front.handles.values() if not h.settled)
        if not (pending or deferred or live):
            return handles
        if front.fleet.ticks >= max_ticks:
            raise RuntimeError(
                f"trace did not drain within {max_ticks} ticks "
                f"({len(pending)} pending, {len(deferred)} deferred, "
                f"{live} live)")
        front.tick()
