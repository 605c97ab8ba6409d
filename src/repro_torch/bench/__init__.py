"""The port's registry-driven dissection harness: a copy of ``repro.bench``.

``repro_torch/benchmarks/*.py`` modules self-register experiments with
paper provenance (section, figure/table, expected values); the runner
executes any subset across the registered device models on a torch
device (``cuda`` unless the caller names another) and emits JSON
artifacts with PASS/DEVIATION verdicts plus the legacy CSV rows, in the
reference's ``repro.bench/v1`` schema.

CLI: ``python -m repro_torch.bench {list,run,report,profile}``.
"""

from repro_torch.bench.registry import (Context, Experiment, REGISTRY,
                                        all_experiments, discover,
                                        experiment, get, select)
from repro_torch.bench.result import (DEVIATION, ERROR, INFO, PASS,
                                      ExperimentRecord, Metric, info,
                                      load_artifact, summarize,
                                      write_artifact)
from repro_torch.bench.runner import (RunOptions, records_to_rows,
                                      run_experiments, run_one)
from repro_torch.bench.report import experiments_doc, render_report

__all__ = [
    "Context", "Experiment", "REGISTRY", "all_experiments", "discover",
    "experiment", "get", "select",
    "DEVIATION", "ERROR", "INFO", "PASS", "ExperimentRecord", "Metric",
    "info", "load_artifact", "summarize", "write_artifact",
    "RunOptions", "records_to_rows", "run_experiments", "run_one",
    "experiments_doc", "render_report",
]
