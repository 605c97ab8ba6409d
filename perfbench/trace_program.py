"""Run one cell with the program's own spans and counters on, and print
what they say.

    python3 perfbench/trace_program.py --workload <cell> --seed <n> \
        --seconds <s> [--whole-window 1]

from the checkout's root, on the cell's cards. The run is the
benchmark's: the same set-up and measured window (``serve_cell.Loop``,
``train_cell.window``), then a profiled sub-window after it, as
``--trace 1`` profiles, with ``repro_torch.tracing`` on in the
sub-window. ``--whole-window 1`` turns the tracing on in the measured
window too: its ``tick_ms`` or ``step_ms`` against those of
``run.py --trace 0`` on the same seed is what the tracing costs. Nothing
is compared with the reference.

The last line of standard output is one JSON object: ``info`` (as
``run.py``'s), ``metrics`` (the readers of ``spans.READ`` that read
something in this cell) and ``trace`` (``spans.reduce`` of the
sub-window, with the program's counters).
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--whole-window", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def sub_window(torch, body, profile: bool) -> dict:
    """``body`` in a ``pb.window`` span with the program's tracing on,
    profiled (``spans.traced``) or, on a CPU, only run; what the
    program's tracing kept is the result's ``program``."""
    from perfbench import devtrace, spans
    from repro_torch import tracing
    state = {}

    def run():
        tracing.drain()
        tracing.enable(True)
        try:
            with devtrace.span("window"):
                body()
        finally:
            tracing.enable(False)
        state["program"] = tracing.drain()

    if profile:
        got = spans.traced(torch, run)
    else:
        run()
        got = {}
    got["program"] = state["program"]
    return got


def serve(cell, seed, seconds, whole, device, profile=True) -> dict:
    """Records of a serving cell, as ``harness.serve_records`` gives
    them, with the program's stamps and spans."""
    import torch

    from perfbench import harness, serve_cell, spans
    from repro_torch import tracing
    t = time.perf_counter()
    _, engine = serve_cell.build(cell, seed, device)
    info = {"build_s": time.perf_counter() - t}
    loop = serve_cell.Loop(cell, engine, seed, seconds)
    tracing.enable(whole)
    try:
        loop.run()
    finally:
        tracing.enable(False)
    kept = tracing.drain()
    win = [t for t in loop.ticks if loop.in_window(t["start"])]
    info.update(setup_s=loop.w0 - T_PROCESS, ticks=len(win),
                tick_ms=sum(t["end"] - t["start"] for t in win)
                / max(1, len(win)) * 1e3, preemptions=engine.preemptions,
                whole_window_spans=len(kept["spans"]),
                # the engine's host time with no profiler running
                whole_window_host_dispatch_ms=spans.host_dispatch_ms(
                    {"program": kept}))
    loop.record_ticks = False
    first = {}

    def body():
        loop.record_ticks = True
        first["tick"] = len(loop.ticks)
        t_end = loop.clock() + serve_cell.TRACE_S
        while loop.clock() < t_end:
            loop.turn(trace=True)
        loop.record_ticks = False

    traced = sub_window(torch, body, profile)
    traced["work"] = serve_cell.tick_work(cell.config,
                                          loop.ticks[first["tick"]:])
    records = harness.serve_records(cell, {"loop": loop, "traced": traced})
    for r, tr in zip(records["requests"], serve_cell.judged_requests(loop)):
        r.update(submitted_at=tr.req.submitted_at,
                 admitted_at=tr.req.admitted_at)
    records["program"] = traced.pop("program")
    records["info"] = info
    return records


def train(cell, seed, seconds, whole, device, profile=True) -> dict:
    """Records of a training cell, as ``harness.train_records`` gives
    them, with the program's spans."""
    import torch

    from perfbench import devtrace, harness, traffic, train_cell
    from repro_torch import tracing
    state, step, _ = train_cell.program(cell, seed, device)
    tracing.enable(whole)
    try:
        win = train_cell.window(cell, state, step, seed, seconds, device)
    finally:
        tracing.enable(False)
    kept = tracing.drain()
    ends = [win["t0"]] + win["ends"]
    info = {"setup_s": win["t0"] - T_PROCESS, "steps": len(win["ends"]),
            "step_ms": [(b - a) * 1e3 for a, b in zip(ends, ends[1:])],
            "whole_window_spans": len(kept["spans"])}

    def body():
        for i in range(win["next"], win["next"] + train_cell.TRACE_STEPS):
            batch = traffic.train_batch(cell.mix, seed, i,
                                        cell.config["vocab_size"], device)
            with devtrace.span("train_step"):
                step(state, batch)
            train_cell._sync(device)

    traced = sub_window(torch, body, profile)
    records = harness.train_records(cell, {"window": win, "traced": traced})
    records["program"] = traced.pop("program")
    records["info"] = info
    return records


def summary(records: dict) -> dict:
    """The result line: info, the metrics read, and the sub-window."""
    from perfbench import spans
    metrics = {}
    for name, read in spans.READ.items():
        value = read(records)
        if value is not None:
            metrics[name] = value
    trace = {k: v for k, v in (records.get("trace") or {}).items()
             if k != "work"}
    trace["counters"] = records["program"]["counters"]
    return {"info": records["info"], "metrics": metrics, "trace": trace}


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import manifest, run
    for key, rel in run.CACHES.items():
        os.environ[key] = str(ROOT / rel)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch
    cell = manifest.load_cell(args.workload, ROOT)
    drive = {"serve": serve, "train": train}[cell.spec["driver"]]
    records = drive(cell, args.seed, args.seconds, bool(args.whole_window),
                    torch.device("cuda"))
    print(json.dumps(summary(records)), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
