"""Measured-vs-published profile diff: the per-field verdict table.

A copy of ``repro/profile/diffing.py`` for the port: the standard
library only, nothing of ``repro``.

Rules follow the repo's bench conventions: structural parameters (size,
line/sector, sets, ways, replacement class, mapping bits) must match
EXACTLY; latency classes are held to a relative tolerance; sustained
bandwidths may sit at or below the published peak (``le``); replacement
probabilities compare sorted (way labels are unobservable, Fig 11).  A
measured ``set_bits`` of ``None`` under stochastic replacement is
reported but not failed — the conflict-stride probe needs deterministic
thrashing, which non-LRU policies deny (the paper recovered Fermi's split
field from miss *addresses*, §4.5).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.profile import MEASURED, PUBLISHED, DeviceProfile

LATENCY_TOL = 0.02
BANDWIDTH_TOL = 0.05
WAY_PROB_TOL = 0.05


@dataclasses.dataclass(frozen=True)
class DiffRow:
    field: str
    measured: object
    published: object
    rule: str                  # "eq" | "close" | "le" | "probs" | "info"
    ok: bool
    note: str = ""


def _close(m: float, e: float, tol: float) -> bool:
    return abs(float(m) - float(e)) <= tol * max(1.0, abs(float(e)))


def _diff_cache(name: str, m, p) -> list[DiffRow]:
    rows = [
        DiffRow(f"{name}/size_bytes", m.size_bytes, p.size_bytes, "eq",
                m.size_bytes == p.size_bytes),
        DiffRow(f"{name}/line_bytes", m.line_bytes, p.line_bytes, "eq",
                m.line_bytes == p.line_bytes),
        DiffRow(f"{name}/num_sets", m.num_sets, p.num_sets, "eq",
                m.num_sets == p.num_sets),
        DiffRow(f"{name}/way_counts", sorted(m.way_counts),
                sorted(p.way_counts), "eq",
                sorted(m.way_counts) == sorted(p.way_counts)),
        DiffRow(f"{name}/is_lru", m.is_lru, p.is_lru, "eq",
                m.is_lru == p.is_lru),
    ]
    if p.set_bits is not None:
        if m.set_bits is None:
            rows.append(DiffRow(
                f"{name}/set_bits", None, list(p.set_bits), "info", True,
                "not probeable (stochastic replacement denies deterministic "
                "thrashing)" if not m.is_lru else "probe found no conflict "
                "stride"))
        else:
            rows.append(DiffRow(f"{name}/set_bits", list(m.set_bits),
                                list(p.set_bits), "eq",
                                list(m.set_bits) == list(p.set_bits)))
    if p.way_probs:
        if m.way_probs:
            err = max(abs(a - b) for a, b in
                      zip(sorted(m.way_probs), sorted(p.way_probs)))
            rows.append(DiffRow(
                f"{name}/way_probs", [round(x, 3) for x in sorted(m.way_probs)],
                [round(x, 3) for x in sorted(p.way_probs)], "probs",
                err <= WAY_PROB_TOL, f"max |Δp| = {err:.3f}"))
        else:
            rows.append(DiffRow(f"{name}/way_probs", None,
                                [round(x, 3) for x in sorted(p.way_probs)],
                                "probs", False, "not recovered"))
    return rows


def diff_profiles(measured: DeviceProfile,
                  published: DeviceProfile) -> list[DiffRow]:
    """Per-field verdicts; published-fallback fields are info rows (there
    is nothing to verify — they ARE the published value)."""
    rows: list[DiffRow] = []
    for name in sorted(published.caches):
        p = published.caches[name]
        m = measured.caches.get(name)
        if m is None or m.provenance == PUBLISHED:
            rows.append(DiffRow(f"{name}/*", "(published fallback)",
                                p.summary(), "info", True))
            continue
        rows.extend(_diff_cache(name, m, p))
    measured_any_latency = any(v == MEASURED
                               for v in measured.latency_provenance.values())
    for cls in sorted(published.latency):
        pv = published.latency[cls]
        mv = measured.latency.get(cls)
        if mv is None:
            # a profile that measured its spectrum but lost a published
            # class is a regression, not a fallback
            rows.append(DiffRow(f"latency/{cls}", None, pv, "eq",
                                not measured_any_latency,
                                "class not measured"))
        elif measured.latency_provenance.get(cls) == PUBLISHED:
            rows.append(DiffRow(f"latency/{cls}", mv, pv, "info", True))
        else:
            rows.append(DiffRow(f"latency/{cls}", mv, pv, "close",
                                _close(mv, pv, LATENCY_TOL),
                                f"tol {LATENCY_TOL:.0%}"))
    missing = sorted(set(measured.latency) - set(published.latency))
    for cls in missing:
        rows.append(DiffRow(f"latency/{cls}", measured.latency[cls], None,
                            "eq", False, "class not published"))
    for key in sorted(published.spec):
        pv = published.spec[key]
        mv = measured.spec.get(key)
        if measured.spec_provenance.get(key) == MEASURED:
            # an on-hardware measurement legitimately disagrees with the
            # datasheet; show it, don't fail it
            rows.append(DiffRow(f"spec/{key}", mv, pv, "info", True,
                                "measured vs datasheet"))
        else:
            # published-provenance spec fields ARE the datasheet: any
            # drift means the artifact was hand-edited or corrupted
            ok = mv is not None and _close(mv, pv, 1e-9)
            rows.append(DiffRow(f"spec/{key}", mv, pv, "eq", ok))
    bw_m, bw_p = measured.bandwidth, published.bandwidth
    if "global_gbps" in bw_m and "global_gbps" in bw_p:
        rows.append(DiffRow("bandwidth/global_gbps", bw_m["global_gbps"],
                            bw_p["global_gbps"], "close",
                            _close(bw_m["global_gbps"], bw_p["global_gbps"],
                                   BANDWIDTH_TOL), f"tol {BANDWIDTH_TOL:.0%}"))
    if "shared_gbps" in bw_m and "shared_gbps" in bw_p:
        ok = bw_m["shared_gbps"] <= bw_p["shared_gbps"] * (1 + BANDWIDTH_TOL)
        rows.append(DiffRow("bandwidth/shared_gbps", bw_m["shared_gbps"],
                            bw_p["shared_gbps"], "le", ok,
                            "sustained (occupancy model) <= Table-7 peak; "
                            "Kepler sits below it — the paper's Fig 16 point"))
    bc_m, bc_p = measured.bank_conflict, published.bank_conflict
    if bc_m.get("table") and bc_p.get("table"):
        rows.append(DiffRow("bank_conflict/table", bc_m["table"],
                            bc_p["table"], "eq",
                            bc_m["table"] == bc_p["table"]))
        slope = float(bc_m.get("slope_cycles_per_way", 0.0))
        flat = measured.generation in ("maxwell", "volta")
        rows.append(DiffRow(
            "bank_conflict/slope_regime", round(slope, 2),
            "< 5 cyc/way" if flat else ">= 5 cyc/way", "close",
            (slope < 5.0) == flat,
            "Maxwell/Volta keep the flattened-conflict hardware fix"))
    return rows


def render_diff(rows: list[DiffRow], title: str = "Profile diff") -> str:
    bad = [r for r in rows if not r.ok]
    lines = [
        f"# {title}",
        "",
        f"**{len(rows) - len(bad)} ok · {len(bad)} mismatched** "
        f"({len(rows)} fields)",
        "",
        "| Field | Measured | Published | Rule | Verdict | Note |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        verdict = "ok" if r.ok else "MISMATCH"
        lines.append(
            f"| {r.field} | {r.measured} | {r.published} | {r.rule} "
            f"| {verdict} | {r.note} |")
    return "\n".join(lines) + "\n"
