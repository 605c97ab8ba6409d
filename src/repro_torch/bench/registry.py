"""Experiment registry for the port's dissection harness.

A copy of ``repro/bench/registry.py``. ``repro_torch/benchmarks/*.py``
modules register one experiment each via the :func:`experiment`
decorator; :func:`discover` imports every module of that package so
nothing is hand-listed anywhere. The decorated function has signature
``fn(ctx: Context) -> list[Metric]`` and is called once per applicable
device. The :class:`Context` also names the torch device the experiment
runs its tensors on: ``cuda`` unless the caller names another.
"""

from __future__ import annotations

import dataclasses
import importlib
import pkgutil
from typing import Callable, Iterable, Mapping

import torch

from repro_torch import resolve_device
from repro_torch.bench.result import Metric
from repro_torch.core import devices as device_registry
from repro_torch.core.devices import DeviceEntry


@dataclasses.dataclass(frozen=True)
class Context:
    """Per-call execution context handed to every experiment function."""

    device: DeviceEntry
    quick: bool = False
    seed: int = 0
    #: where the experiment's tensors live and its kernels launch
    torch_device: torch.device = dataclasses.field(
        default_factory=resolve_device)


ExperimentFn = Callable[[Context], "list[Metric]"]


@dataclasses.dataclass(frozen=True)
class Experiment:
    """A registered experiment and its paper provenance."""

    name: str
    fn: ExperimentFn
    title: str
    section: str                       # paper section, e.g. "§4.4"
    artifact: str                      # "Table 5", "Fig 8", "beyond-paper"
    devices: tuple[str, ...]
    tags: tuple[str, ...] = ()
    expected: Mapping[str, str] = dataclasses.field(default_factory=dict)
    # ^ human-readable paper-published values, keyed by claim

    def applicable(self, device: str) -> bool:
        return device in self.devices

    def run(self, ctx: Context) -> list[Metric]:
        return self.fn(ctx)


REGISTRY: dict[str, Experiment] = {}


def experiment(*, name: str | None = None, title: str, section: str,
               artifact: str, devices: Iterable[str],
               tags: Iterable[str] = (),
               expected: Mapping[str, str] | None = None):
    """Decorator: register ``fn(ctx) -> list[Metric]`` as an experiment.

    ``name`` defaults to the defining module's basename (so
    ``repro_torch/benchmarks/fig8_tlb.py`` registers ``fig8_tlb``).
    Devices must already exist in the port's
    :data:`repro_torch.core.devices.DEVICE_REGISTRY`.
    """

    def deco(fn: ExperimentFn) -> ExperimentFn:
        exp_name = name or fn.__module__.rsplit(".", 1)[-1]
        devs = tuple(devices)
        for d in devs:
            device_registry.get_device(d)      # fail fast on typos
        exp = Experiment(name=exp_name, fn=fn, title=title, section=section,
                         artifact=artifact, devices=devs, tags=tuple(tags),
                         expected=dict(expected or {}))
        prev = REGISTRY.get(exp_name)
        if prev is not None:
            # Tolerate re-imports of the same module; reject true
            # collisions.
            if (prev.fn.__module__, prev.fn.__qualname__) != (
                    fn.__module__, fn.__qualname__):
                raise ValueError(
                    f"experiment {exp_name!r} already registered by "
                    f"{prev.fn.__module__}.{prev.fn.__qualname__}")
        REGISTRY[exp_name] = exp
        fn.experiment = exp            # backref for direct calls in tests
        return fn

    return deco


def discover(package: str = "repro_torch.benchmarks") -> list[str]:
    """Import every module in ``package`` so decorators run.

    Returns the imported module basenames.  Helper modules that register
    nothing (``common``, ``run``) are skipped by name; anything else that
    fails to import is a hard error — silently dropping an experiment is
    exactly the failure mode the registry exists to prevent.
    """
    pkg = importlib.import_module(package)
    names = []
    for info in pkgutil.iter_modules(pkg.__path__):
        base = info.name
        if base.startswith("_") or base in ("common", "run"):
            continue
        importlib.import_module(f"{package}.{base}")
        names.append(base)
    return names


def get(name: str) -> Experiment:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown experiment {name!r}; "
                       f"registered: {sorted(REGISTRY)}") from None


def all_experiments() -> list[Experiment]:
    return [REGISTRY[k] for k in sorted(REGISTRY)]


def select(device: str | None = None, tag: str | None = None,
           section: str | None = None,
           names: Iterable[str] | None = None) -> list[Experiment]:
    """Filter registered experiments; substring match for section."""
    exps = all_experiments()
    if names:
        wanted = set(names)
        unknown = wanted - set(REGISTRY)
        if unknown:
            raise KeyError(f"unknown experiments: {sorted(unknown)}")
        exps = [e for e in exps if e.name in wanted]
    if device:
        exps = [e for e in exps if e.applicable(device)]
    if tag:
        exps = [e for e in exps if tag in e.tags]
    if section:
        exps = [e for e in exps if section in e.section]
    return exps
