"""Little's-law capacity planner: λ + SLO → replica count, per profile.

A copy of ``repro/serve/planner.py`` for the port: accounting only,
no parameters and no device.

This module inverts the serving stack.  Everything so far answers "what
latency does THIS fleet give this traffic"; the planner answers the
question operators actually ask — **how many replicas of which device
profile do I need for arrival rate λ at SLO X** — using only the repo's
own dissection laws, no simulation:

* **Little's law** (paper §5.1, ``core.littles_law``): a replica's
  useful concurrency is capped by its latency-hiding in-flight quantum —
  ``tpu_required_inflight_bytes(spec) / gather_row_bytes`` sequences keep
  the HBM pipe covered; more just queues (the same bound the fleet
  router penalizes, so the plan and the runtime agree on what "full"
  means).  A dissected :meth:`~repro_torch.core.profile.DeviceProfile
  .serving_spec` changes this bound through its measured bandwidth and
  latency — which is how GTX980 vs TeslaV100 vs tpu_v5e plans differ.
* **Queueing**: each replica serves ``C`` requests concurrently (slots,
  pages and the inflight bound — the binding constraint wins), but
  chunked prefill is SERIALIZED: the engine prefills only the oldest
  admitted request per tick, so a replica can START at most one request
  per ``prefill_ticks``.  Service rate is therefore
  ``μ = min(C / W₀, 1 / prefill_ticks)`` with ``W₀`` the uncontended
  residence (prefill ticks + one tick per decoded token after the
  first, which the prefill-completing chunk step emits itself).
* **M/M/1-shaped waiting**: at utilization ``ρ = λ / (N·μ)`` the
  admission queue adds ``prefill_ticks · ρ/(1−ρ)`` of wait, so predicted
  TTFT is ``prefill_ticks / (1−ρ)`` and predicted residence is
  ``W = W₀ + prefill_ticks · ρ/(1−ρ)``.  The planner picks the smallest
  ``N`` with ``ρ ≤ max_utilization`` and predicted TTFT within the SLO.

Everything is in **tick units** — deterministic, device-free — and the
plan carries one scoped ``decode_cell_cost(...).step_s`` so the same
numbers price out in seconds per device (:meth:`CapacityPlan
.to_seconds`).  The prediction is falsifiable and the ``serve_workload``
experiment falsifies it: predicted residence W is gated against the
simulated fleet's measured mean residence (``SLOReport``), where
Little's law ``L = λ·W`` holds exactly by construction.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import littles_law, profile
from repro_torch.core.costmodel import (ParallelismPlan, decode_cell_cost,
                                  prefill_cell_cost)
from repro_torch.models.config import ModelConfig
from repro_torch.serve import paging, tiers as tiering

_SINGLE_CHIP = ParallelismPlan(dp=1, tp=1, fsdp=False)

#: hard cap on the replica search (a plan that needs more is infeasible)
MAX_REPLICAS = 64


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """The service-level objective a plan must meet, in tick units."""

    ttft_p99_ticks: float = 32.0       # predicted p99 time-to-first-token
    max_utilization: float = 0.85      # ρ ceiling (headroom for bursts)

    def __post_init__(self):
        if self.ttft_p99_ticks <= 0:
            raise ValueError(
                f"ttft_p99_ticks must be positive, got {self.ttft_p99_ticks}")
        if not 0 < self.max_utilization < 1:
            raise ValueError(
                f"max_utilization must be in (0, 1), got "
                f"{self.max_utilization}")


@dataclasses.dataclass(frozen=True)
class ReplicaModel:
    """One replica's capacity characterization on one device profile —
    derived from geometry and the dissection laws, never from a running
    engine (the planner must not need params or a device)."""

    spec_name: str
    page_len: int
    prefill_chunk: int
    num_pages: int
    max_slots: int
    pages_per_request: int     # worst-case pages the MEAN request holds
    inflight_bound: int        # Little's-law concurrency quantum
    concurrency: int           # C: min(slots, page capacity, inflight)
    binding: str               # which constraint set C
    prefill_ticks: int         # serialized admission: 1 request starts / this
    service_ticks: float       # W0: uncontended residence
    service_rate: float        # μ = min(C / W0, 1 / prefill_ticks)
    step_s: float              # one decode tick on this spec, at load C


@dataclasses.dataclass(frozen=True)
class CapacityPlan:
    """The planner's answer for one (traffic, profile, SLO) triple."""

    arrival_per_tick: float
    mean_prompt: float
    mean_new: float
    replica: ReplicaModel
    slo: SLOTarget
    replicas: int
    utilization: float                  # ρ at the chosen N
    predicted_ttft_ticks: float         # prefill_ticks / (1 - ρ)
    predicted_residence_ticks: float    # W = W0 + prefill·ρ/(1-ρ)
    predicted_concurrency: float        # L = λ·W (Little's law)
    feasible: bool

    def to_seconds(self) -> dict[str, float]:
        """Price the tick-unit plan on the replica's device."""
        s = self.replica.step_s
        return {
            "step_s": s,
            "predicted_ttft_s": self.predicted_ttft_ticks * s,
            "predicted_residence_s": self.predicted_residence_ticks * s,
            "arrival_per_s": self.arrival_per_tick / s,
            "tokens_per_s": (self.arrival_per_tick * self.mean_new) / s,
        }

    def lines(self) -> list[str]:
        """Human-readable block (the launcher prints it)."""
        r = self.replica
        sec = self.to_seconds()
        return [
            f"traffic: λ={self.arrival_per_tick:.3f}/tick, "
            f"mean prompt={self.mean_prompt:.1f}, "
            f"mean new={self.mean_new:.1f}",
            f"replica[{r.spec_name}]: C={r.concurrency} "
            f"(binding: {r.binding}; slots={r.max_slots}, "
            f"pages={r.num_pages}/{r.pages_per_request} per req, "
            f"inflight_bound={r.inflight_bound}), "
            f"prefill={r.prefill_ticks} ticks, W0={r.service_ticks:.1f}, "
            f"mu={r.service_rate:.4f}/tick",
            f"plan: N={self.replicas} replicas at rho={self.utilization:.2f} "
            f"(SLO: ttft_p99<={self.slo.ttft_p99_ticks:g} ticks, "
            f"rho<={self.slo.max_utilization:g})"
            + ("" if self.feasible else "  ** INFEASIBLE **"),
            f"predicted: TTFT={self.predicted_ttft_ticks:.1f} ticks "
            f"({sec['predicted_ttft_s'] * 1e3:.2f} ms), "
            f"residence W={self.predicted_residence_ticks:.1f} ticks, "
            f"L=lambda*W={self.predicted_concurrency:.1f} live "
            f"(Little's law)",
        ]


def characterize_replica(cfg: ModelConfig, *, spec=None,
                         max_slots: int, max_len: int,
                         mean_prompt: float, mean_new: float,
                         page_len: int | None = None,
                         num_pages: int | None = None,
                         prefill_chunk: int | None = None) -> ReplicaModel:
    """Derive one replica's capacity model from geometry + profile.

    Mirrors ``PagedServeEngine.__init__``'s derivations exactly (page
    length from :func:`paging.choose_page_len`, dense-equivalent pool
    default, chunk-padded frontier) so the plan describes the engine the
    launcher would actually build.
    """
    spec = profile.resolve_spec(spec)
    page_len = page_len or paging.choose_page_len(
        cfg, spec=spec, expected_tokens=max_len)
    prefill_chunk = prefill_chunk or page_len
    if prefill_chunk % page_len:
        raise ValueError(f"prefill_chunk {prefill_chunk} must be a "
                         f"multiple of page_len {page_len}")
    frontier = -(-max_len // prefill_chunk) * prefill_chunk
    pages_per_seq = -(-frontier // page_len)
    if num_pages is None:
        num_pages = max_slots * pages_per_seq + paging.SCRATCH_PAGES
    capacity = num_pages - paging.SCRATCH_PAGES

    # the mean request's worst-case page footprint (chunk-padded prefill
    # frontier or fully-decoded length, as engine._worst_case_pages)
    plen = max(1, int(round(mean_prompt)))
    n_new = max(1, int(round(mean_new)))
    pad_end = -(-plen // prefill_chunk) * prefill_chunk
    pages_per_request = -(-max(pad_end, plen + n_new) // page_len)

    # Little's law: sequences whose gather rows cover the in-flight
    # quantum (same derivation as FleetReplica.inflight_bound)
    row_bytes = page_len * max(1, paging.kv_bytes_per_token_layer(cfg))
    inflight_bound = max(1, round(
        littles_law.tpu_required_inflight_bytes(spec) / row_bytes))

    bounds = {
        "slots": max_slots,
        "pages": max(1, capacity // pages_per_request),
        "inflight": inflight_bound,
    }
    binding = min(bounds, key=lambda k: (bounds[k], k))
    concurrency = bounds[binding]

    prefill_ticks = max(1, -(-plen // prefill_chunk))
    # the prefill-completing chunk step emits the FIRST token itself, so
    # decode only needs n_new - 1 further ticks (1 token / decode tick)
    service_ticks = float(prefill_ticks + max(0, n_new - 1))
    service_rate = min(concurrency / service_ticks, 1.0 / prefill_ticks)

    cell = decode_cell_cost(cfg, global_batch=concurrency,
                            seq=min(max_len, plen + n_new),
                            plan=_SINGLE_CHIP,
                            name=f"planner/{spec.name}")
    return ReplicaModel(
        spec_name=spec.name, page_len=page_len, prefill_chunk=prefill_chunk,
        num_pages=num_pages, max_slots=max_slots,
        pages_per_request=pages_per_request, inflight_bound=inflight_bound,
        concurrency=concurrency, binding=binding,
        prefill_ticks=prefill_ticks, service_ticks=service_ticks,
        service_rate=service_rate, step_s=cell.step_s(spec))


def plan_capacity(cfg: ModelConfig, *, arrival_per_tick: float,
                  mean_prompt: float, mean_new: float,
                  spec=None, max_slots: int, max_len: int,
                  slo: SLOTarget | None = None,
                  page_len: int | None = None,
                  num_pages: int | None = None,
                  prefill_chunk: int | None = None,
                  max_replicas: int = MAX_REPLICAS) -> CapacityPlan:
    """Smallest replica count meeting the SLO at arrival rate λ.

    Walks N upward until utilization clears ``slo.max_utilization`` AND
    the predicted TTFT (``prefill_ticks / (1−ρ)``) meets the target.  An
    infeasible plan (no N ≤ ``max_replicas`` works) is returned with
    ``feasible=False`` at ``max_replicas`` rather than raised — the
    launcher prints it, the benchmark asserts on it.
    """
    if arrival_per_tick <= 0:
        raise ValueError(
            f"arrival_per_tick must be positive, got {arrival_per_tick}")
    slo = slo or SLOTarget()
    rep = characterize_replica(
        cfg, spec=spec, max_slots=max_slots, max_len=max_len,
        mean_prompt=mean_prompt, mean_new=mean_new, page_len=page_len,
        num_pages=num_pages, prefill_chunk=prefill_chunk)

    chosen, feasible = max_replicas, False
    for n in range(1, max_replicas + 1):
        rho = arrival_per_tick / (n * rep.service_rate)
        if rho > slo.max_utilization:
            continue
        if rep.prefill_ticks / (1.0 - rho) > slo.ttft_p99_ticks:
            continue
        chosen, feasible = n, True
        break

    rho = arrival_per_tick / (chosen * rep.service_rate)
    # at an infeasible rho >= 1 the M/M/1 wait diverges; report inf
    if rho < 1.0:
        wait = rep.prefill_ticks * rho / (1.0 - rho)
        ttft = rep.prefill_ticks / (1.0 - rho)
    else:
        wait = math.inf
        ttft = math.inf
    residence = rep.service_ticks + wait
    return CapacityPlan(
        arrival_per_tick=arrival_per_tick, mean_prompt=mean_prompt,
        mean_new=mean_new, replica=rep, slo=slo, replicas=chosen,
        utilization=rho, predicted_ttft_ticks=ttft,
        predicted_residence_ticks=residence,
        predicted_concurrency=arrival_per_tick * residence,
        feasible=feasible)


def plan_for_trace(cfg: ModelConfig, trace, *, spec=None,
                   max_slots: int, max_len: int,
                   slo: SLOTarget | None = None,
                   **kw) -> CapacityPlan:
    """Plan against a generated trace's MEASURED characterization
    (:meth:`~repro_torch.serve.workload.Trace.stats`) — bursty and
    session-expanded traces are priced by what actually arrives, not the
    nominal rate."""
    st = trace.stats()
    if not st["requests"]:
        raise ValueError("cannot plan for an empty trace")
    return plan_capacity(
        cfg, arrival_per_tick=st["arrival_per_tick"],
        mean_prompt=st["mean_prompt"], mean_new=st["mean_new"],
        spec=spec, max_slots=max_slots, max_len=max_len, slo=slo, **kw)


def rank_profiles(cfg: ModelConfig, profiles, *, arrival_per_tick: float,
                  mean_prompt: float, mean_new: float,
                  max_slots: int, max_len: int,
                  slo: SLOTarget | None = None,
                  **kw) -> list[CapacityPlan]:
    """One plan per candidate profile, best first: feasible plans before
    infeasible, then fewest replicas, then fastest step — the
    "which profile" half of the planner question.  ``profiles`` entries
    resolve through :func:`~repro_torch.serve.fleet.resolve_fleet_profile`
    (names, artifacts, specs)."""
    from repro_torch.serve.fleet import resolve_fleet_profile
    plans = [plan_capacity(cfg, arrival_per_tick=arrival_per_tick,
                           mean_prompt=mean_prompt, mean_new=mean_new,
                           spec=resolve_fleet_profile(p),
                           max_slots=max_slots, max_len=max_len,
                           slo=slo, **kw)
             for p in profiles]
    return sorted(plans, key=lambda p: (not p.feasible, p.replicas,
                                        p.replica.step_s))


# -- tiered (disaggregated) planning -----------------------------------------


@dataclasses.dataclass(frozen=True)
class TierAnswer:
    """One tier's sizing on one device profile: how many replicas of
    which profile this STAGE needs at arrival rate λ."""

    tier: str                   # "prefill" | "decode"
    spec_name: str
    replicas: int
    utilization: float          # ρ at the chosen count
    service_rate: float         # μ per replica, requests/tick
    stage_ticks: float          # one request's residence in this stage
    step_s: float               # one stage step on this spec (tier-priced)
    feasible: bool

    def line(self) -> str:
        return (f"{self.tier}[{self.spec_name}]: N={self.replicas} at "
                f"rho={self.utilization:.2f} "
                f"(mu={self.service_rate:.4f}/tick, "
                f"stage={self.stage_ticks:.1f} ticks, "
                f"step={self.step_s * 1e3:.3f} ms)"
                + ("" if self.feasible else "  ** INFEASIBLE **"))


@dataclasses.dataclass(frozen=True)
class TieredCapacityPlan:
    """The planner's per-tier answer for a disaggregated fleet: the best
    (profile, count) per stage, the priced handoff between them, and the
    end-to-end TTFT prediction that includes the handoff ticks (the same
    accounting rule the fleet's SLO layer enforces)."""

    prefill: TierAnswer
    decode: TierAnswer
    ranked_prefill: tuple[TierAnswer, ...]   # all candidates, best first
    ranked_decode: tuple[TierAnswer, ...]
    handoff_s: float
    handoff_ticks: int
    predicted_ttft_ticks: float
    feasible: bool

    def lines(self) -> list[str]:
        return [
            self.prefill.line(),
            self.decode.line(),
            f"handoff: {self.handoff_s * 1e6:.2f} us = "
            f"{self.handoff_ticks} decode tick(s) "
            f"(min-endpoint bandwidth + worst-endpoint latency)",
            f"predicted TTFT: {self.predicted_ttft_ticks:.1f} ticks "
            f"(prefill wait + prefill + handoff)"
            + ("" if self.feasible else "  ** INFEASIBLE **"),
        ]


def _size_stage(arrival: float, mu: float, max_util: float,
                max_replicas: int) -> tuple[int, float, bool]:
    """Smallest replica count keeping ρ = λ/(N·μ) under the ceiling."""
    for n in range(1, max_replicas + 1):
        rho = arrival / (n * mu)
        if rho <= max_util:
            return n, rho, True
    return max_replicas, arrival / (max_replicas * mu), False


def plan_tiers(cfg: ModelConfig, profiles, *, arrival_per_tick: float,
               mean_prompt: float, mean_new: float,
               max_slots: int, max_len: int,
               slo: SLOTarget | None = None,
               max_replicas: int = MAX_REPLICAS,
               **kw) -> TieredCapacityPlan:
    """Per-tier capacity answer for a disaggregated fleet.

    The two stages see the same arrival rate λ but different service
    laws, so they size independently:

    * **prefill** — chunked prefill is serialized (one start per
      ``prefill_ticks``), so a prefill specialist's rate is
      ``μ_p = 1/prefill_ticks`` regardless of slots; the stage is priced
      per profile with :func:`~repro_torch.core.costmodel.prefill_cell_cost`
      (bandwidth-rich specs win).
    * **decode** — ``C`` concurrent streams each resident
      ``max(1, n_new−1)`` ticks gives ``μ_d = C/decode_ticks``; priced
      with ``decode_cell_cost`` at load C (low-latency specs win).

    Each tier's candidates are ranked (feasible first, fewest replicas,
    fastest tier-priced step) and the winners joined by the KV handoff —
    whole prompt pages at ``min(src, dst)`` bandwidth, quantized against
    the decode winner's step — which lands in the predicted TTFT exactly
    as the fleet's SLO accounting lands it in the measured one.
    """
    from repro_torch.serve.fleet import resolve_fleet_profile
    if arrival_per_tick <= 0:
        raise ValueError(
            f"arrival_per_tick must be positive, got {arrival_per_tick}")
    slo = slo or SLOTarget()
    specs = [profile.resolve_spec(resolve_fleet_profile(p))
             for p in profiles]
    plen = max(1, int(round(mean_prompt)))
    n_new = max(1, int(round(mean_new)))
    decode_ticks = float(max(1, n_new - 1))

    pre, dec = [], []
    reps = {}
    for spec in specs:
        rep = characterize_replica(
            cfg, spec=spec, max_slots=max_slots, max_len=max_len,
            mean_prompt=mean_prompt, mean_new=mean_new, **kw)
        reps[spec.name] = rep
        mu_p = 1.0 / rep.prefill_ticks
        n_p, rho_p, ok_p = _size_stage(arrival_per_tick, mu_p,
                                       slo.max_utilization, max_replicas)
        pcell = prefill_cell_cost(cfg, global_batch=1, seq=plen,
                                  plan=_SINGLE_CHIP,
                                  name=f"planner/{spec.name}")
        pre.append(TierAnswer(
            tier="prefill", spec_name=spec.name, replicas=n_p,
            utilization=rho_p, service_rate=mu_p,
            stage_ticks=float(rep.prefill_ticks),
            step_s=pcell.step_s(spec), feasible=ok_p))
        mu_d = rep.concurrency / decode_ticks
        n_d, rho_d, ok_d = _size_stage(arrival_per_tick, mu_d,
                                       slo.max_utilization, max_replicas)
        dec.append(TierAnswer(
            tier="decode", spec_name=spec.name, replicas=n_d,
            utilization=rho_d, service_rate=mu_d,
            stage_ticks=decode_ticks, step_s=rep.step_s, feasible=ok_d))

    key = lambda a: (not a.feasible, a.replicas, a.step_s, a.spec_name)
    pre.sort(key=key)
    dec.sort(key=key)
    best_p, best_d = pre[0], dec[0]

    by_name = {s.name: s for s in specs}
    src, dst = by_name[best_p.spec_name], by_name[best_d.spec_name]
    rep_p = reps[best_p.spec_name]
    pad_end = -(-plen // rep_p.prefill_chunk) * rep_p.prefill_chunk
    n_pages = -(-pad_end // rep_p.page_len)
    h_bytes = tiering.handoff_bytes(cfg, n_pages, rep_p.page_len)
    h_s = tiering.handoff_seconds(h_bytes, src, dst)
    h_ticks = tiering.handoff_ticks(h_s, best_d.step_s)

    # M/M/1 wait at the prefill stage, then the handoff in flight
    if best_p.utilization < 1.0:
        ttft = (best_p.stage_ticks / (1.0 - best_p.utilization)) + h_ticks
    else:
        ttft = math.inf
    feasible = (best_p.feasible and best_d.feasible
                and ttft <= slo.ttft_p99_ticks)
    return TieredCapacityPlan(
        prefill=best_p, decode=best_d,
        ranked_prefill=tuple(pre), ranked_decode=tuple(dec),
        handoff_s=h_s, handoff_ticks=h_ticks,
        predicted_ttft_ticks=ttft, feasible=feasible)
