"""Legacy CSV entry point; delegates to the ``repro_torch.bench`` registry.

Twin of ``benchmarks/run.py``. Every module in this package
self-registers via the ``@experiment`` decorator (discovered with
``repro_torch.bench.discover()``). Prefer the full CLI:

  PYTHONPATH=src python -m repro_torch.bench run [--quick] [--strict] ...

This wrapper keeps the historical ``name,us_per_call,derived`` CSV
behavior: ``python -m repro_torch.benchmarks.run [substring]`` runs every
experiment whose name contains the substring and prints CSV rows to
stdout. Tensors live on the card unless ``--torch-device`` names another
torch device (``cpu`` runs the plain versions).
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv: list[str] | None = None) -> None:
    from repro_torch.bench import (discover, records_to_rows, registry,
                                   run_experiments)
    from repro_torch.bench.runner import RunOptions

    ap = argparse.ArgumentParser(prog="python -m repro_torch.benchmarks.run")
    ap.add_argument("only", nargs="?", default=None,
                    help="run the experiments whose name holds this")
    ap.add_argument("--torch-device", default="cuda",
                    help="torch device of the tensors and kernels")
    args = ap.parse_args(argv)
    discover()
    only = args.only
    names = tuple(n for n in registry.REGISTRY
                  if only is None or only in n)
    if not names:
        print(f"no experiment matches {only!r}; registered: "
              f"{sorted(registry.REGISTRY)}", file=sys.stderr)
        raise SystemExit(2)
    print("name,us_per_call,derived")
    t0 = time.time()
    records = run_experiments(RunOptions(names=names,
                                         torch_device=args.torch_device))
    for name, us, derived in records_to_rows(records):
        print(f"{name},{us:.1f},{derived}")
    print(f"# total {time.time() - t0:.1f}s", file=sys.stderr)


if __name__ == "__main__":
    main()
