"""Find the knee of an open-loop serving cell: the highest arrival rate
the program sustains without a growing backlog.

    python3 perfbench/sweep.py --workload granite-8b.chat --seed 11 \
        --rates 1.5,2,2.5,3 --ramp 25 --seconds 40

One process builds the cell's engine once and offers each rate in turn
for ``--ramp`` + ``--seconds`` seconds of the mix's traffic at that rate
(the engine emptied between rates). For each rate it prints one JSON
line: requests due and finished in the measured part, output tokens/s,
the backlog (requests waiting for a slot or for their prefill chunks)'s
mean over the first and the second half of the measured part and at its
end, and the TTFT and TPOT percentiles of the
requests due in the first half. A rate is sustained where the queue does
not grow from the first half to the second. Not run by the benchmark's
cells: the cell's mix file holds the rate this sweep found, as a number.
"""

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def offer(cell, engine, seed: int, rate: float, ramp: float,
          seconds: float) -> dict:
    from perfbench import serve_cell, stats
    mix = dict(cell.mix, rate_rps=rate, ramp_s=ramp)
    loop = serve_cell.Loop(dataclasses.replace(cell, mix=mix), engine, seed,
                           seconds)
    loop.start()
    queue = []
    while loop.clock() < loop.w1:
        loop.turn()
        now = loop.clock()
        if now >= loop.w0:
            queue.append((now, len(engine.waiting) + len(engine.prefilling)))
    mid = loop.w0 + seconds / 2
    first = [q for t, q in queue if t < mid]
    second = [q for t, q in queue if t >= mid]
    early = [t for t in loop.tracks if loop.w0 <= t.due < mid]
    ttft = [(t.first - t.due) * 1e3 for t in early if t.first is not None]
    tpot = [(t.last - t.first) / (t.seen - 1) * 1e3 for t in early
            if t.seen >= 2]
    out = {"rate_rps": rate,
           "due": len(loop.window_due()),
           "finished": sum(t.done is not None for t in loop.window_due()),
           "output_tok_s": sum(t.in_window_tokens for t in loop.tracks)
           / seconds,
           "queue_first_half": sum(first) / max(1, len(first)),
           "queue_second_half": sum(second) / max(1, len(second)),
           "queue_end": queue[-1][1] if queue else 0,
           "ticks": len([t for t in loop.ticks if t["start"] >= loop.w0]),
           "ttft_p50_ms": stats.percentile(ttft, 50) if ttft else None,
           "ttft_p95_ms": stats.percentile(ttft, 95) if ttft else None,
           "tpot_p95_ms": stats.percentile(tpot, 95) if tpot else None}
    for t in loop.tracks:
        if t.done is None:
            engine.cancel(t.req.uid)
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--ramp", type=float, default=25.0)
    p.add_argument("--seconds", type=float, default=40.0)
    args = p.parse_args()
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from perfbench import manifest, serve_cell
    cell = manifest.load_cell(args.workload, ROOT)
    t = time.perf_counter()
    _, engine = serve_cell.build(cell, args.seed, torch.device("cuda"))
    print(json.dumps({"setup_s": time.perf_counter() - t,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    for rate in (float(r) for r in args.rates.split(",")):
        print(json.dumps(offer(cell, engine, args.seed, rate, args.ramp,
                               args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
