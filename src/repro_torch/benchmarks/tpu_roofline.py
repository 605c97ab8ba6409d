"""Beyond-paper: the three-term TPU roofline for every dry-run cell.

Twin of ``benchmarks/tpu_roofline.py``. Reads the port's own
``build/repro_torch/dryrun/single/*.json`` (produced by
``python -m repro_torch.launch.dryrun --mesh single``) and reports the
per-cell analytic terms; falls back to computing the analytic model
directly for every cell with no dry-run record. The terms are a
``tpu_v5e`` pod's, priced by the model: nothing here is measured."""

from __future__ import annotations

import glob
import json
import os

from repro_torch.bench import Context, Metric, experiment, info

#: where the dry-run records are read (a test points it elsewhere)
DRYRUN_ROOT = "build/repro_torch/dryrun"


def _fmt(r: dict) -> str:
    return (f"dom={r['dominant']} compute={r['compute_s']*1e3:.1f}ms "
            f"memory={r['memory_s']*1e3:.1f}ms "
            f"coll={r['collective_s']*1e3:.1f}ms "
            f"roofline={r['roofline_fraction']:.1%} "
            f"useful={r['useful_ratio']:.2f}")


def _cells(quick: bool, root: str | None = None):
    """(label, roofline dict, analytic?) for every supported cell."""
    from repro_torch import configs
    from repro_torch.configs.shapes import SHAPES, cell_supported
    from repro_torch.core import costmodel
    from repro_torch.core.costmodel import ParallelismPlan

    out = []
    seen = set()
    pattern = os.path.join(root or DRYRUN_ROOT, "single", "*__*.json")
    for f in sorted(glob.glob(pattern)):
        with open(f) as fh:
            rec = json.load(fh)
        if rec.get("tag", "baseline") != "baseline":
            continue
        seen.add((rec["arch"], rec["shape"]))
        out.append((f"{rec['arch']}/{rec['shape']}", rec["roofline"], False))
    plan = ParallelismPlan(dp=16, tp=16)
    archs = configs.list_archs()
    if quick:
        archs = archs[:2]
    for arch in archs:
        cfg = configs.get_config(arch)
        for shape in SHAPES.values():
            if not cell_supported(cfg, shape)[0]:
                continue
            if (arch, shape.name) in seen:
                continue
            c = costmodel.cell_cost(cfg, shape, plan)
            out.append((f"{arch}/{shape.name}", c.to_json(), True))
    return out


@experiment(
    title="Three-term roofline for every model x workload cell",
    section="beyond-paper",
    artifact="roofline",
    devices=("tpu_v5e",),
    tags=("tpu", "roofline", "costmodel"),
    expected={})
def run(ctx: Context) -> list[Metric]:
    cells = _cells(ctx.quick)
    metrics: list[Metric] = [
        info(f"cell/{label}", _fmt(r),
             detail="analytic-only" if analytic else "dry-run")
        for label, r, analytic in cells
    ]
    fracs = [r["roofline_fraction"] for _, r, _ in cells]
    metrics += [
        Metric("num_cells", len(cells), 1, cmp="ge",
               detail="supported model x workload cells"),
        Metric("max_roofline_fraction", round(max(fracs), 3), 1.0, cmp="le",
               tol=0.0, detail="no cell can beat the hardware roofline"),
        Metric("terms_nonnegative",
               all(min(r["compute_s"], r["memory_s"], r["collective_s"]) >= 0
                   for _, r, _ in cells), True, cmp="eq"),
    ]
    return metrics
