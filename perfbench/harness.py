"""One run of one cell: the checks before it, the cell's driver, the
metrics, the comparison and the result line.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``, and last ``checks``: each number compared beside its
limit, which also end standard error.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

from perfbench import judge, manifest, stats

#: top-level module names that must not be loaded in the process that
#: prints a result: JAX and the JAX package of the repository
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class RunError(RuntimeError):
    """A run that prints no result."""


def forbidden_modules() -> list[str]:
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def check_cards(torch, chips: int) -> None:
    if not torch.cuda.is_available():
        raise RunError("torch sees no CUDA card: the benchmark runs on an "
                       "NVIDIA GPU")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell asks for {chips} cards; torch sees "
                       f"{torch.cuda.device_count()}")


def serve_records(cell, got) -> dict:
    from perfbench.serve_cell import judged_requests
    loop = got["loop"]
    reqs = [{"due": t.due, "admit": t.admit, "first": t.first,
             "last": t.last, "done": t.done, "seen": t.seen}
            for t in judged_requests(loop)]
    return {"kind": "serve", "loop": loop.mix["loop"],
            "config": cell.config, "cell": cell.spec,
            "window": (loop.w0, loop.w1), "waited": loop.w1 + loop.drain,
            "ticks": loop.ticks, "requests": reqs, "trace": got["traced"]}


def train_records(cell, got) -> dict:
    win = got["window"]
    return {"kind": "train", "config": cell.config, "cell": cell.spec,
            "mix": cell.mix, "window": (win["t0"], win["ends"][-1]),
            "steps": len(win["ends"]), "trace": got["traced"]}


def serve_outcome(cell, got) -> tuple[dict, dict, int, int]:
    """(end-to-end values, compared numbers, attempted, failed)."""
    from perfbench.serve_cell import served
    e = got["e2e"]
    values = {"setup_s": got["setup_s"],
              "output_tok_s": e["output_tok_s"]}
    if e["ttft"]:
        values["ttft_p95_ms"] = stats.percentile(e["ttft"], 95)
    if e["tpot"]:
        values["tpot_p95_ms"] = stats.percentile(e["tpot"], 95)
    device = got["weights"]["embed"].device
    numbers = {"gap_max": float("nan"), "gap_mean": float("nan")}
    if got["sample"]:
        gaps, _ = judge.served_gaps(got["weights"], got["config"],
                                    *served(got["sample"], device))
        numbers = {"gap_max": float(gaps.max()),
                   "gap_mean": float(gaps.double().mean())}
    got["info"]["ttft_ms"] = quartiles(e["ttft"])
    got["info"]["tpot_ms"] = quartiles(e["tpot"])
    return values, numbers, e["attempted"], e["failed"]


def quartiles(values) -> dict:
    """p50, p75, p90, p95 and max of a run's values, for the info line."""
    if not values:
        return {}
    return {f"p{q}": stats.percentile(values, q) for q in (50, 75, 90, 95,
                                                           100)}


def train_outcome(cell, got) -> tuple[dict, dict, int, int]:
    win = got["window"]
    tokens = cell.mix["batch"] * cell.mix["seq_len"]
    seconds = win["ends"][-1] - win["t0"]
    values = {"setup_s": got["setup_s"],
              "train_tok_s": tokens * len(win["ends"]) / seconds}
    numbers = judge.train_numbers(got["program"], got["reference"])
    return values, numbers, len(win["ends"]), 0


def per_layer(cell, records: dict, here: Path | None = None) -> dict:
    out = {}
    for m in cell.per_layer:
        value = manifest.load_reader(m["name"], here)(records)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_process: float, card: dict | None = None,
             here: Path | None = None) -> dict:
    """Drive the cell's run and build its result (without printing)."""
    if cell.spec["driver"] == "serve":
        from perfbench import serve_cell as driver
        outcome, records = serve_outcome, serve_records
    elif cell.spec["driver"] == "train":
        from perfbench import train_cell as driver
        outcome, records = train_outcome, train_records
    else:
        raise RunError(f"unknown driver {cell.spec['driver']!r}")
    got = driver.run(cell, seed, seconds, trace, device, t_process)
    t_check = time.perf_counter()
    values, numbers, attempted, failed = outcome(cell, got)
    info = dict(got.get("info", {}), check_s=time.perf_counter() - t_check,
                values=values)
    ok, checks = judge.verdict(numbers, cell.spec["limits"])
    if trace:
        metrics = per_layer(cell, records(cell, got), here)
    else:
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise RunError(f"the run has no value of {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dev = dict(card or {}, memory_peak_bytes=int(got["peak"]))
    result = {"correct": ok and failed == 0, "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    traced = got.get("traced")
    if traced is not None:
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["checks"] = checks
    result["_info"] = info
    return result


def emit(result: dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    info = result.pop("_info", None)
    if info is not None:
        print(f"info {json.dumps(info)}", file=sys.stderr, flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
