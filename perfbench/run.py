"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the checkout's root, on a machine with the cards the cell asks for.
Set-up (weights and traffic from the seed, the program's warm-up, the
traffic's ramp) counts from this process's start; the window measures for
``--seconds``; the comparison with the plain reference runs after it.
``--trace 1`` profiles a short steady sub-window after the measured one
and prints the per-layer metrics in place of the end-to-end ones. The
last line of standard output is the result, as JSON.

Every cache the program or PyTorch writes lies under ``build/`` in the
checkout, at fixed paths, so only the first run of a checkout builds.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHES = {"TRITON_CACHE_DIR": "build/triton",
          "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "PYTORCH_KERNEL_CACHE_PATH": "build/torch_kernels"}


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import harness, manifest
    try:
        cell = manifest.load_cell(args.workload, ROOT)
        import torch
        harness.check_cards(torch, cell.chips)
        card = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": cell.chips}
        result = harness.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), torch.device("cuda"),
                                  T_PROCESS, card)
    except (harness.RunError, KeyError, FileNotFoundError,
            ModuleNotFoundError) as err:
        print(f"error: {err}", file=sys.stderr, flush=True)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"error: the process loaded {found} (JAX or the JAX package)",
              file=sys.stderr, flush=True)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
