"""Markdown rendering: the verdict report and the experiment catalogue.

A copy of ``repro/bench/report.py`` for the port. ``render_report`` turns
a list of records (or a JSON artifact) into the human-readable verdict
table; ``experiments_doc`` renders the catalogue purely from the port's
registry metadata, so it cannot drift from the code. The port writes no
file under ``docs/``: those are the JAX package's generated documents.
"""

from __future__ import annotations

from repro_torch.bench import registry
from repro_torch.bench.result import DEVIATION, ERROR, ExperimentRecord, summarize
from repro_torch.core import devices as device_registry


def _md_escape(v: object) -> str:
    return str(v).replace("|", "\\|").replace("\n", " ")


def render_report(records: list[ExperimentRecord], title: str = "Dissection report") -> str:
    """The per-run verdict report (experiment × device)."""
    s = summarize(records)
    lines = [
        f"# {title}",
        "",
        f"**{s['PASS']} PASS · {s['DEVIATION']} DEVIATION · "
        f"{s['ERROR']} ERROR · {s['INFO']} info-only** "
        f"({len(records)} experiment×device records)",
        "",
        "| Experiment | Device | Paper artifact | Verdict | Time (s) | Deviations |",
        "|---|---|---|---|---:|---|",
    ]
    for r in records:
        devs = "; ".join(
            f"{m.name}: {m.measured} vs {m.expected}" for m in r.deviations)
        if r.error:
            devs = r.error.strip().splitlines()[-1]
        lines.append(
            f"| {r.experiment} | {r.device} | {r.artifact} ({r.section}) "
            f"| {r.verdict} | {r.elapsed_s:.2f} | {_md_escape(devs)} |")
    # harness-speed ledger: stable experiment×device order so successive
    # reports diff cleanly when a record regresses
    total = sum(r.elapsed_s for r in records)
    lines += ["", "## Harness wall time", "",
              f"**total {total:.2f} s across {len(records)} records**", "",
              "| Experiment | Device | elapsed_s |", "|---|---|---:|"]
    for r in sorted(records, key=lambda r: (r.experiment, r.device)):
        lines.append(f"| {r.experiment} | {r.device} | {r.elapsed_s:.2f} |")
    # per-record metric detail
    for r in records:
        lines += ["", f"## {r.experiment} × {r.device} — {r.verdict}", ""]
        if r.error:
            lines += ["```", r.error.strip(), "```"]
            continue
        lines += [
            "| Metric | Measured | Expected | Rule | Verdict |",
            "|---|---|---|---|---|",
        ]
        for m in r.metrics:
            exp = "—" if m.cmp == "info" else _md_escape(m.expected)
            rule = m.cmp if m.cmp in ("eq", "info", "range") else (
                f"{m.cmp} ±{m.tol:g}")
            meas = _md_escape(m.measured)
            if m.unit:
                meas += f" {m.unit}"
            lines.append(f"| {m.name} | {meas} | {exp} | {rule} "
                         f"| {m.verdict} |")
    return "\n".join(lines) + "\n"


DOC_HEADER = """\
# Experiment catalogue

<!-- GENERATED FILE — do not edit by hand.
     Rendered by repro_torch.bench.report.experiments_doc() -->

Every experiment below registers itself with `repro_torch.bench` via the
`@experiment` decorator in its `src/repro_torch/benchmarks/<name>.py`
module; this table is rendered from that registry metadata, so it cannot
drift from the code.  Run any subset with
`python -m repro_torch.bench run --only <name>` and render verdicts with
`python -m repro_torch.bench report`.
"""


def experiments_doc() -> str:
    """Render the experiment catalogue from the registry (discover()
    first)."""
    exps = registry.all_experiments()
    lines = [
        DOC_HEADER,
        "| Experiment | Paper artifact | Section | Devices | Tags |",
        "|---|---|---|---|---|",
    ]
    for e in exps:
        lines.append(
            f"| `{e.name}` | {e.artifact} | {e.section} "
            f"| {', '.join(e.devices)} | {', '.join(e.tags) or '—'} |")
    lines += ["", "## Paper-published expected values", ""]
    for e in exps:
        lines += [f"### `{e.name}` — {e.title}", ""]
        if not e.expected:
            lines += ["(beyond-paper experiment: sanity bounds only)", ""]
            continue
        lines += ["| Claim | Paper value |", "|---|---|"]
        for claim, value in e.expected.items():
            lines.append(f"| {_md_escape(claim)} | {_md_escape(value)} |")
        lines.append("")
    lines += ["## Registered devices", "",
              "| Device | Kind | Generation |", "|---|---|---|"]
    for d in device_registry.list_devices():
        lines.append(f"| {d.name} | {d.kind} | {d.generation} |")
    return "\n".join(lines) + "\n"
