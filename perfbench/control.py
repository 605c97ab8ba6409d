"""The control of a cell's comparison: the readings that set a limit's
upper end, on the chip at the cell's own size.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 20] [--ramp 20]

Serving: the cell runs a short window at its own load and drains; the
sampled requests' prompts and served tokens go through the float32
reference and through the reference with every product in fp8 e4m3 (the
precision below the configuration's bf16). It prints, per seed, the
program's ``gap_max`` and the control's: the widest gap of the tokens the
fp8 reference puts first at the same positions. Training: the float32
reference, the fp8 one and the float32 one fed half of each batch (the
fault of a step that leaves half of the batch out) follow the checked
steps; it prints the numbers of the program's set-up steps, of the
control and of the fault, each against the float32 reference. Not run
by the benchmark's cells.
"""

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def serve_control(cell, seed: int, seconds: float, device) -> dict:
    import torch
    from perfbench import judge, serve_cell
    weights, engine = serve_cell.build(cell, seed, device)
    loop = serve_cell.Loop(cell, engine, seed, seconds)
    loop.run()
    picked = serve_cell.sample(loop, seed, cell.spec["sample"])
    engine.cache = None
    loop.engine = None
    del engine
    torch.cuda.empty_cache()
    gaps, low = judge.served_gaps(
        weights, cell.config, *serve_cell.served(picked, device),
        lower=("bf16", "fp8"))
    return {"program": judge.gap_stats(gaps),
            **{name: judge.gap_stats(g) for name, g in low.items()},
            "requests": len(picked)}


def train_control(cell, seed: int, device) -> dict:
    import torch
    from perfbench import judge, train_cell
    state, step, prog = train_cell.program(cell, seed, device)
    del state, step
    torch.cuda.empty_cache()
    n = cell.spec["train"]["reference_steps"] + 1
    prog["losses"] = prog["losses"][:n]
    f32 = train_cell.reference(cell, seed, device)
    out = {}
    for name, got in (("program", prog),
                      ("control", train_cell.reference(cell, seed, device,
                                                       prec="fp8")),
                      ("half_batch", train_cell.reference(
                          cell, seed, device, half_batch=True))):
        out[name] = dict(judge.train_numbers(got, f32),
                         loss_steps=judge.loss_gaps(got, f32))
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--ramp", type=float, default=None)
    args = p.parse_args()
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from perfbench import manifest
    cell = manifest.load_cell(args.workload, ROOT)
    if args.ramp is not None:
        cell = dataclasses.replace(cell, mix=dict(cell.mix, ramp_s=args.ramp))
    dev = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        if cell.spec["driver"] == "serve":
            got = serve_control(cell, seed, args.seconds, dev)
        else:
            got = train_control(cell, seed, dev)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "seconds": time.perf_counter() - t, **got}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
