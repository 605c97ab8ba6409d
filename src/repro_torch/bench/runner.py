"""Execute registered experiments across registered devices.

A copy of ``repro/bench/runner.py`` for the port. One
:class:`~repro_torch.bench.result.ExperimentRecord` per experiment ×
device. The runner never imports individual benchmark modules — it only
sees the registry — so adding an experiment is one decorated function in
``repro_torch/benchmarks/`` and nothing else.

With ``jobs > 1`` the experiment × device records fan out over a process
pool of *spawned* workers: CUDA does not survive ``fork``, and the parent
touches no CUDA before the pool starts, so each worker initialises it
lazily. Scheduling is invisible in the output: records come back in the
same deterministic order as the serial path, each record's seed is a
stable hash of ``(base seed, experiment, device)`` rather than anything
execution-order-dependent, and ``elapsed_s`` is still measured around the
experiment body inside the worker. Workers rebuild the registry via
``registry.discover()``, attach the same trace cache as the parent and
run on the parent's torch device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import multiprocessing
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Callable, Iterable

from repro_torch import resolve_device
from repro_torch.bench import registry
from repro_torch.bench.registry import Context, Experiment
from repro_torch.bench.result import ExperimentRecord, Metric
from repro_torch.core import devices as device_registry
from repro_torch.core import tracecache
from repro_torch.kernels import KERNELS

Row = tuple[str, float, str]     # legacy CSV row: name, us_per_call, derived

#: where the port's harness writes its artifacts (never experiments/)
ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch" \
    / "bench"

@dataclasses.dataclass(frozen=True)
class RunOptions:
    device: str | None = None          # restrict to one device
    tag: str | None = None
    section: str | None = None
    names: tuple[str, ...] = ()
    quick: bool = False
    seed: int = 0
    jobs: int = 1                      # >1: experiment×device process pool
    trace_cache_root: str | None = None  # propagated to pool workers
    torch_device: str = "cuda"         # where tensors live, kernels launch


def record_seed(base: int, experiment: str, device: str) -> int:
    """Deterministic per-record seed: independent of pool scheduling, run
    order, and jobs count — a record reruns identically in any context."""
    h = hashlib.sha256(f"{base}:{experiment}:{device}".encode()).digest()
    return int.from_bytes(h[:4], "little")


def kernel_launches() -> dict[str, int]:
    """Each kernel wrapper's launch count in this process."""
    return {name: importlib.import_module(f"repro_torch.kernels.{name}")
            .launches for name in KERNELS}


def _launches_since(before: dict[str, int]) -> dict[str, int]:
    return {name: n - before[name] for name, n in kernel_launches().items()}


def _count(total: dict[str, int] | None, made: dict[str, int]) -> None:
    if total is not None:
        for name, n in made.items():
            total[name] = total.get(name, 0) + n


def run_experiments(opts: RunOptions = RunOptions(),
                    progress: Callable[[str], None] | None = None,
                    launches: dict[str, int] | None = None,
                    ) -> list[ExperimentRecord]:
    """Run the selected experiments on every applicable device.

    Where ``launches`` is given, the kernel launches that the run made,
    in this process and in the pool's workers, are added to it by kernel
    name."""
    exps = registry.select(device=opts.device, tag=opts.tag,
                           section=opts.section, names=opts.names or None)
    tasks: list[tuple[Experiment, str]] = [
        (exp, dev) for exp in exps for dev in exp.devices
        if not (opts.device and dev != opts.device)]
    if opts.jobs > 1 and len(tasks) > 1:
        return _run_pooled(tasks, opts, progress, launches)
    before = kernel_launches()
    records: list[ExperimentRecord] = []
    for exp, dev_name in tasks:
        if progress:
            progress(f"{exp.name} × {dev_name}")
        records.append(run_one(exp, dev_name, quick=opts.quick,
                               seed=record_seed(opts.seed, exp.name,
                                                dev_name),
                               torch_device=opts.torch_device))
    _count(launches, _launches_since(before))
    return records


def run_one(exp: Experiment, device: str, quick: bool = False,
            seed: int = 0, torch_device: str = "cuda") -> ExperimentRecord:
    ctx = Context(device=device_registry.get_device(device), quick=quick,
                  seed=seed, torch_device=resolve_device(torch_device))
    t0 = time.perf_counter()
    metrics: list[Metric] = []
    error = None
    try:
        metrics = list(exp.run(ctx))
    except Exception:
        error = traceback.format_exc(limit=8)
    return ExperimentRecord(
        experiment=exp.name, device=device, section=exp.section,
        artifact=exp.artifact, metrics=metrics,
        elapsed_s=time.perf_counter() - t0, error=error)


# ---------------------------------------------------------------------------
# process-pool fan-out
# ---------------------------------------------------------------------------


def _worker_init(trace_cache_root: str | None) -> None:
    registry.discover()
    if trace_cache_root:
        tracecache.configure(trace_cache_root)


#: artifact consulted for longest-first pool scheduling (best effort)
HINT_ARTIFACT = str(ARTIFACT_DIR / "latest.json")


def _historical_costs(path: str = HINT_ARTIFACT) -> dict[tuple[str, str], float]:
    """(experiment, device) -> elapsed_s from the port's last artifact, for
    makespan-friendly submission order.  Purely a scheduling hint: results
    and their order are identical whether or not the file exists."""
    try:
        with open(path) as fh:
            payload = json.load(fh)
        return {(r["experiment"], r["device"]): float(r.get("elapsed_s", 0))
                for r in payload.get("records", [])}
    except (OSError, ValueError, KeyError):
        return {}


def _worker_run_batch(items: list[tuple[str, str, int]], quick: bool,
                      torch_device: str
                      ) -> tuple[list[ExperimentRecord], dict[str, int]]:
    """The batch's records, and the kernel launches it made."""
    before = kernel_launches()
    records = [run_one(registry.get(name), device, quick=quick, seed=seed,
                       torch_device=torch_device)
               for name, device, seed in items]
    return records, _launches_since(before)


def _run_pooled(tasks: list[tuple[Experiment, str]], opts: RunOptions,
                progress: Callable[[str], None] | None,
                launches: dict[str, int] | None,
                ) -> list[ExperimentRecord]:
    jobs = min(opts.jobs, len(tasks))
    costs = _historical_costs()

    def cost(i: int) -> float:
        return costs.get((tasks[i][0].name, tasks[i][1]), float("inf"))

    # The accelerator's records run as ONE sequential batch on one worker:
    # on the card that is the worker that launches the kernels, and they
    # overlap the simulator records on the other workers.
    tpu_idx = [i for i, (_, dev) in enumerate(tasks)
               if device_registry.get_device(dev).kind == "tpu"]
    solo_idx = [i for i in range(len(tasks)) if i not in set(tpu_idx)]
    # longest-first submission; unknown records first (assume heavy)
    solo_idx.sort(key=lambda i: -cost(i))
    results: list = [None] * len(tasks)
    with ProcessPoolExecutor(
            max_workers=jobs, mp_context=multiprocessing.get_context("spawn"),
            initializer=_worker_init,
            initargs=(opts.trace_cache_root,)) as pool:
        futures = []
        if len(tpu_idx) > 1:
            for i in tpu_idx:
                if progress:
                    progress(f"{tasks[i][0].name} × {tasks[i][1]}")
            batch = [(tasks[i][0].name, tasks[i][1],
                      record_seed(opts.seed, tasks[i][0].name, tasks[i][1]))
                     for i in tpu_idx]
            futures.append((tpu_idx, pool.submit(
                _worker_run_batch, batch, opts.quick, opts.torch_device)))
        else:
            solo_idx = sorted(solo_idx + tpu_idx, key=lambda i: -cost(i))
        for i in solo_idx:
            exp, dev = tasks[i]
            if progress:
                progress(f"{exp.name} × {dev}")
            futures.append(([i], pool.submit(
                _worker_run_batch,
                [(exp.name, dev, record_seed(opts.seed, exp.name, dev))],
                opts.quick, opts.torch_device)))
        for idxs, fut in futures:
            records, made = fut.result()
            for i, rec in zip(idxs, records):
                results[i] = rec
            _count(launches, made)
    # original task order, not completion or submission order
    return results


def records_to_rows(records: Iterable[ExperimentRecord]) -> list[Row]:
    """Flatten records into the legacy ``name,us_per_call,derived`` rows."""
    rows: list[Row] = []
    for rec in records:
        for m in rec.metrics:
            derived = f"{m.measured}"
            if m.unit:
                derived += f"{m.unit}"
            if m.cmp != "info":
                derived += f" [expect {m.expected} -> {m.verdict}]"
            if m.detail:
                derived += f" ({m.detail})"
            rows.append((f"{rec.experiment}/{rec.device}/{m.name}", m.us,
                         derived.replace(",", ";")))
        if rec.error:
            rows.append((f"{rec.experiment}/{rec.device}/ERROR", 0.0,
                         rec.error.strip().splitlines()[-1].replace(",", ";")))
    return rows
