"""Structured results for the dissection harness.

A copy of ``repro/bench/result.py`` for the port, with the same schema,
comparison rules and verdict folding, so that an artifact written by
either package loads in both.

Every experiment emits :class:`Metric` values — one measured number (or
label) next to the paper's published expectation and a comparison rule.
The runner folds the metrics of one experiment × device run into an
:class:`ExperimentRecord` carrying a single PASS/DEVIATION verdict, and a
list of records round-trips through the JSON artifact
(``schema = "repro.bench/v1"``) that CI diffs against its baseline.

Comparison rules (``cmp``):

* ``close`` — relative error ``|m - e| <= tol * max(1, |e|)`` (default)
* ``eq``    — exact equality (ints, strings, bools)
* ``le`` / ``ge`` — one-sided bounds, slack ``tol * max(1, |e|)``
* ``range`` — expected is ``[lo, hi]``, inclusive
* ``info``  — no expectation; never affects the verdict
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

SCHEMA = "repro.bench/v1"

PASS = "PASS"
DEVIATION = "DEVIATION"
INFO = "INFO"
ERROR = "ERROR"

_CMPS = ("close", "eq", "le", "ge", "range", "info")


@dataclasses.dataclass(frozen=True)
class Metric:
    """One measured quantity with its paper-published expectation."""

    name: str
    measured: Any
    expected: Any = None
    cmp: str = "close"
    tol: float = 0.05
    unit: str = ""
    detail: str = ""
    us: float = 0.0          # wall-time of the underlying measurement

    def __post_init__(self) -> None:
        if self.cmp not in _CMPS:
            raise ValueError(f"unknown cmp {self.cmp!r}; one of {_CMPS}")
        if self.cmp != "info" and self.expected is None:
            raise ValueError(f"metric {self.name!r}: cmp={self.cmp!r} "
                             "requires an expected value")
        # numpy scalars would stringify in the JSON artifact and then fail
        # eq comparisons on reload; normalize to native Python types here
        for field in ("measured", "expected"):
            v = getattr(self, field)
            if hasattr(v, "item") and not isinstance(v, (str, bytes)):
                object.__setattr__(self, field, v.item())

    @property
    def verdict(self) -> str:
        if self.cmp == "info":
            return INFO
        m, e = self.measured, self.expected
        if self.cmp == "eq":
            return PASS if m == e else DEVIATION
        try:
            m = float(m)
        except (TypeError, ValueError):
            return DEVIATION
        if self.cmp == "range":
            lo, hi = float(e[0]), float(e[1])
            return PASS if lo <= m <= hi else DEVIATION
        e = float(e)
        slack = self.tol * max(1.0, abs(e))
        if self.cmp == "close":
            return PASS if abs(m - e) <= slack else DEVIATION
        if self.cmp == "le":
            return PASS if m <= e + slack else DEVIATION
        return PASS if m >= e - slack else DEVIATION      # ge

    def to_json(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["verdict"] = self.verdict
        return d

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "Metric":
        d = {k: v for k, v in d.items() if k != "verdict"}
        return cls(**d)


def info(name: str, measured: Any, *, unit: str = "", detail: str = "",
         us: float = 0.0) -> Metric:
    """Shorthand for a verdict-neutral metric."""
    return Metric(name, measured, cmp="info", unit=unit, detail=detail, us=us)


@dataclasses.dataclass
class ExperimentRecord:
    """One experiment × device run: metrics plus the folded verdict."""

    experiment: str
    device: str
    section: str
    artifact: str
    metrics: list[Metric]
    elapsed_s: float = 0.0
    error: str | None = None

    @property
    def verdict(self) -> str:
        if self.error is not None:
            return ERROR
        vs = [m.verdict for m in self.metrics]
        if DEVIATION in vs:
            return DEVIATION
        return PASS if PASS in vs else INFO

    @property
    def deviations(self) -> list[Metric]:
        return [m for m in self.metrics if m.verdict == DEVIATION]

    def to_json(self) -> dict[str, Any]:
        return {
            "experiment": self.experiment,
            "device": self.device,
            "section": self.section,
            "artifact": self.artifact,
            "verdict": self.verdict,
            "elapsed_s": round(self.elapsed_s, 3),
            "error": self.error,
            "metrics": [m.to_json() for m in self.metrics],
        }

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "ExperimentRecord":
        return cls(
            experiment=d["experiment"], device=d["device"],
            section=d["section"], artifact=d["artifact"],
            metrics=[Metric.from_json(m) for m in d["metrics"]],
            elapsed_s=d.get("elapsed_s", 0.0), error=d.get("error"))


def write_artifact(records: list[ExperimentRecord], path: str,
                   extra: dict[str, Any] | None = None) -> dict[str, Any]:
    """Write the JSON artifact; returns the serialized payload."""
    # no timestamp: the artifact is committed as a baseline and must not
    # churn when results are identical
    payload = {
        "schema": SCHEMA,
        "summary": summarize(records),
        "records": [r.to_json() for r in records],
    }
    if extra:
        payload.update(extra)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=1, sort_keys=True, default=str)
        fh.write("\n")
    return payload


def load_artifact(path: str) -> list[ExperimentRecord]:
    with open(path) as fh:
        payload = json.load(fh)
    if payload.get("schema") != SCHEMA:
        raise ValueError(f"{path}: unknown schema {payload.get('schema')!r}")
    return [ExperimentRecord.from_json(r) for r in payload["records"]]


def summarize(records: list[ExperimentRecord]) -> dict[str, int]:
    out = {PASS: 0, DEVIATION: 0, INFO: 0, ERROR: 0}
    for r in records:
        out[r.verdict] += 1
    return out
