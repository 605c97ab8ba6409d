"""The benchmark's manifest and the files it names.

``BENCHMARK.json`` at the checkout's root lists the cells (``workloads``)
and metrics. Everything that belongs to one configuration, traffic mix,
cell or per-layer metric sits in a file of its own under this folder,
found by its name alone:

- ``configs/<config>.json``: one model configuration (published sizes,
  the dtype, each changed key, ``assumed``, ``departures``, and ``port``,
  the program's ``ModelConfig`` fields);
- ``mixes/<traffic>.json``: one traffic mix's parameters;
- ``cells/<workload>.json``: one cell's engine or training settings, the
  sample the check draws and the limits of its comparison;
- ``metrics/<metric>.py``: one per-layer metric's reader, a module with
  ``read(records) -> float | None``.

Adding a configuration, mix, cell or metric adds files and an entry in
``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Cell:
    """One cell as a run needs it: its manifest entry, its own file, its
    configuration's and its mix's, and the metrics it reports."""
    name: str
    chips: int
    entry: dict
    spec: dict
    config: dict
    mix: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str, root: Path | None = None,
              here: Path | None = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files, which
    lie under ``here`` (this folder unless named)."""
    root = Path(root) if root is not None else HERE.parent
    here = Path(here) if here is not None else HERE
    bench = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"it has {sorted(entries)}")
    entry = entries[name]
    spec = load_json(here / "cells" / f"{name}.json")
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    mix = load_json(here / "mixes" / f"{entry['traffic']}.json")
    return Cell(name=name, chips=int(entry["chips"]), entry=entry,
                spec=spec, config=config, mix=mix,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def load_reader(metric: str, here: Path | None = None):
    """``metrics/<metric>.py``'s ``read`` function, loaded by file path
    (a metric's name may hold dots)."""
    here = Path(here) if here is not None else HERE
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def port_config(config: dict):
    """The program's ``ModelConfig`` for a configuration file."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**config["port"])
