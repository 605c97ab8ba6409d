"""Disaggregated prefill/decode tier assignment + KV-handoff pricing.

A copy of ``repro/serve/tiers.py`` for the port: pure policy, nothing
of ``repro``.

The paper's P1–P6 latency spectrum and Table-7 bandwidths parameterize
exactly the split modern serving exploits: **prefill** is bandwidth/
FLOP-bound (one long chunked pass over the prompt, activation + cache
*writes* dominating), **decode** is latency/Little's-law-bound (one
token per tick, the whole live cache re-read every step).  A
heterogeneous fleet should therefore play to type — route prefill to
bandwidth-rich replicas, decode to low-latency ones — instead of taking
whole requests symmetrically.

This module is the pure-policy half of that split; ``repro_torch.serve.fleet``
consumes it:

* :class:`TierPlan` — which replica indices may take prefill placements
  and which may take decode placements.  A replica may sit in both
  tiers; when *every* replica does, the plan is *symmetric* and the
  fleet degenerates bit-for-bit to today's single-stage router (the
  oracle-chain link ``tests/test_serve_tiers.py`` pins).
* :func:`parse_tiers` — the ``--fleet-tiers prefill:0,1/decode:2,3``
  CLI grammar.
* :func:`auto_tiers` — rank replicas by their *measured* profile: high
  global-memory bandwidth (the Volta dissection's Table-7 quantity,
  carried as ``serving_spec().hbm_bytes_per_s``) pulls a replica toward
  the prefill tier, low P4 DRAM latency (``hbm_latency_s``) toward the
  decode tier.
* :func:`handoff_bytes` / :func:`handoff_seconds` /
  :func:`handoff_ticks` — the KV handoff between tiers modeled as a
  paged-page transfer: whole source pages move at ``min(src, dst)``
  measured global-memory bandwidth (the slower endpoint gates the
  wire), plus one worst-endpoint DRAM round trip to start the burst.
  The tick cost quantizes that against the destination's own decode
  step so handoff latency lands in the fleet's tick clock — and
  therefore in TTFT — instead of vanishing between tiers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.serve import paging


@dataclasses.dataclass(frozen=True)
class TierPlan:
    """Replica indices eligible for each routing stage.

    ``prefill`` receives fresh admissions and re-prefill migrations
    (stage 1); ``decode`` receives post-prefill handoffs (stage 2).
    Both tuples are sorted, non-empty, and may overlap — a replica in
    both tiers serves whole requests exactly as the symmetric fleet
    does.
    """

    prefill: tuple[int, ...]
    decode: tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "prefill", tuple(sorted(self.prefill)))
        object.__setattr__(self, "decode", tuple(sorted(self.decode)))
        if not self.prefill or not self.decode:
            raise ValueError(f"both tiers need at least one replica: {self}")

    @property
    def tiered(self) -> bool:
        """True when any replica is specialized — i.e. the plan is NOT
        the symmetric fleet.  A symmetric plan must degenerate to the
        single-stage router bit-for-bit."""
        return set(self.prefill) != set(self.decode)

    def validate(self, n_replicas: int) -> "TierPlan":
        members = set(self.prefill) | set(self.decode)
        bad = [i for i in members if not 0 <= i < n_replicas]
        if bad:
            raise ValueError(
                f"tier plan names replicas {sorted(bad)} but the fleet "
                f"has {n_replicas}")
        orphans = set(range(n_replicas)) - members
        if orphans:
            raise ValueError(
                f"replicas {sorted(orphans)} belong to no tier")
        return self

    def describe(self) -> str:
        return (f"prefill:{','.join(map(str, self.prefill))}"
                f"/decode:{','.join(map(str, self.decode))}")


def symmetric(n_replicas: int) -> TierPlan:
    """Every replica in both tiers — today's fleet, spelled as a plan."""
    allr = tuple(range(n_replicas))
    return TierPlan(prefill=allr, decode=allr)


def parse_tiers(text: str, n_replicas: int) -> TierPlan:
    """Parse ``prefill:0,1/decode:2,3`` (either order; ``auto`` and
    ``none`` are resolved by the caller, not here)."""
    parts: dict[str, tuple[int, ...]] = {}
    for field in text.strip().split("/"):
        if ":" not in field:
            raise ValueError(
                f"bad tier field {field!r} in {text!r} "
                "(want prefill:IDX,.../decode:IDX,...)")
        name, _, idxs = field.partition(":")
        name = name.strip().lower()
        if name not in ("prefill", "decode"):
            raise ValueError(f"unknown tier {name!r} in {text!r}")
        if name in parts:
            raise ValueError(f"tier {name!r} given twice in {text!r}")
        try:
            parts[name] = tuple(int(t) for t in idxs.split(",") if t.strip())
        except ValueError as e:
            raise ValueError(f"bad replica index in {text!r}") from e
    if set(parts) != {"prefill", "decode"}:
        raise ValueError(f"{text!r} must name both tiers")
    return TierPlan(prefill=parts["prefill"],
                    decode=parts["decode"]).validate(n_replicas)


def auto_tiers(specs: Sequence) -> TierPlan:
    """Assign tiers from the measured profile, deterministically.

    Each replica gets a *prefill affinity* (its global-memory bandwidth
    normalized to the fleet's best — Table-7's quantity) and a *decode
    affinity* (the fleet's best P4 DRAM latency normalized to its own).
    Replicas are ranked by ``prefill_affinity - decode_affinity``
    (bandwidth-rich first, ties broken by index) and the top half takes
    the prefill tier.  A one-replica fleet stays symmetric — there is
    nothing to specialize.
    """
    n = len(specs)
    if n < 2:
        return symmetric(n)
    bw = [float(s.hbm_bytes_per_s) for s in specs]
    lat = [float(s.hbm_latency_s) for s in specs]
    best_bw, best_lat = max(bw), min(lat)
    edge = [(bw[i] / best_bw) - (best_lat / lat[i]) for i in range(n)]
    ranked = sorted(range(n), key=lambda i: (-edge[i], i))
    n_prefill = -(-n // 2)                      # ceil: prefill gets the tie
    return TierPlan(prefill=tuple(ranked[:n_prefill]),
                    decode=tuple(ranked[n_prefill:])).validate(n)


def resolve_tiers(tiers, n_replicas: int, specs: Sequence) -> TierPlan:
    """One front door for everything the fleet/CLI accepts: ``None``
    (symmetric), ``"auto"`` (profile-ranked), a grammar string, or a
    prebuilt :class:`TierPlan`."""
    if tiers is None:
        return symmetric(n_replicas)
    if isinstance(tiers, TierPlan):
        return tiers.validate(n_replicas)
    if isinstance(tiers, str):
        text = tiers.strip().lower()
        if text in ("", "none", "symmetric"):
            return symmetric(n_replicas)
        if text == "auto":
            return auto_tiers(specs)
        return parse_tiers(tiers, n_replicas)
    raise TypeError(f"cannot resolve a tier plan from {type(tiers)!r}")


# -- handoff pricing ---------------------------------------------------------


def handoff_bytes(cfg, n_pages: int, page_len: int) -> int:
    """Bytes a KV handoff moves: WHOLE source pages (the transfer unit
    is the page, exactly like the gather row), not just the stored
    tokens — chunk-padding slack rides along."""
    return n_pages * page_len * paging.kv_bytes_per_token(cfg)


def handoff_seconds(n_bytes: int, src_spec, dst_spec) -> float:
    """Paged-page transfer time: the payload at ``min(src, dst)``
    measured global-memory bandwidth (both endpoints touch every byte;
    the slower one gates the wire) plus one worst-endpoint DRAM round
    trip to launch the burst (the paper's P4 quantity)."""
    bw = min(float(src_spec.hbm_bytes_per_s),
             float(dst_spec.hbm_bytes_per_s))
    lat = max(float(src_spec.hbm_latency_s), float(dst_spec.hbm_latency_s))
    return n_bytes / bw + lat


def handoff_ticks(handoff_s: float, dst_step_s: float) -> int:
    """Quantize a handoff against the DESTINATION's decode step: the
    ticks its batch turns over while the pages are in flight.  Never
    zero — a handoff that cost nothing would vanish from TTFT, and the
    whole point of pricing it is that it cannot."""
    return max(1, math.ceil(handoff_s / max(dst_step_s, 1e-12)))
