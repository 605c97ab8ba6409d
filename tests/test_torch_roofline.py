"""The port's roofline and perf driver against the reference's arithmetic.

* ``StepCounter``, the twin of the reference's ``TestCollectiveParsing``:
  x (8, 512) on ("data", "model") times w (512, 512) on ("model", None)
  over a fake (2, 4) mesh, the product brought back to its batch
  layout. Contracting the model-sharded dimension issues an all-reduce of
  the local (4, 512) f32 partial sums, 8192 bytes; the counted flops are
  the local product's, 2·8·512·512 / 8. Meta and CPU tensors count alike.
* ``analyze`` on hand-built costs and collective payloads equals the
  reference's ``analyze`` fed HLO text carrying the same payloads, every
  field of ``to_json`` (terms, dominant, step, fractions), per-device
  and global.
* ``perf``: ``CELLS`` equals the reference's (names, hypotheses,
  predictions, rules, cfg and plan; read from a subprocess, since
  importing the reference's driver sets ``XLA_FLAGS`` for its process).
  Each cell's accept/reject sequence, with ``dryrun.run_cell`` priced
  by the analytic model alone, equals the one the reference's
  ``costmodel.cell_cost`` gives under the same stacked overrides. Then
  the real ``run`` hill-climbs one cell on the ``tiny`` mesh at smoke
  widths.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.configs.shapes import SHAPES as JSHAPES
from repro.core import costmodel as jcostmodel
from repro.core import roofline as jroofline
from repro_torch import configs
from repro_torch.configs.shapes import SHAPES
from repro_torch.core import costmodel, roofline
from repro_torch.launch import dryrun, perf
from repro_torch.parallel.dtensor_tools import fake_world

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


# -- the counter ----------------------------------------------------------------


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_counter_sees_the_contraction_collective(device):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        x = DTensor.from_local(torch.ones(4, 128, device=device), mesh,
                               [Shard(0), Shard(1)], run_check=False,
                               shape=(8, 512), stride=(512, 1))
        w = DTensor.from_local(torch.ones(128, 512, device=device), mesh,
                               [Replicate(), Shard(0)], run_check=False,
                               shape=(512, 512), stride=(512, 1))
        with roofline.StepCounter((x, w)) as c:
            y = (x @ w).redistribute(mesh, [Shard(0), Replicate()])
        assert y.to_local().shape == (4, 512)
    assert not dist.is_initialized()
    assert c.collectives, "contracting a model-sharded dim must " \
                          "emit a collective"
    assert c.collectives == {"all-reduce": 4 * 512 * 4}
    assert c.flops == 2 * 8 * 512 * 512 // 8
    # the local product reads x's and w's shards and writes its result
    assert c.bytes >= (4 * 128 + 128 * 512 + 4 * 512) * 4
    assert c.peak >= 4 * 512 * 4


def test_counter_skips_views_and_counts_temp_past_the_arguments():
    a = torch.ones(64, 64)
    with roofline.StepCounter((a,)) as c:
        v = a.view(4096).view(64, 64)        # views: no bytes, no temp
        assert c.bytes == 0 and c.peak == 0
        b = v @ v                            # 16 KiB made
        del b
        d = a + 1                            # 16 KiB made, b freed
    assert c.flops == 2 * 64 ** 3
    assert c.peak == 64 * 64 * 4 and d.shape == (64, 64)
    assert c.cost() == {"flops": float(c.flops),
                        "bytes accessed": float(c.bytes)}


# -- analyze --------------------------------------------------------------------

PAYLOADS = {"all-gather": 8 * 512 * 4 + 2 * 1024 * 2,
            "all-reduce": 4 * 1024 * 2, "reduce-scatter": 2 * 256 * 4}
HLO = "\n".join([
    "%ag = f32[8,512]{1,0} all-gather(f32[4,512]{1,0} %x), dimensions={0}",
    "%s = (bf16[2,1024]{1,0}, bf16[2,1024]{1,0}) all-gather-start(%y)",
    "%d = bf16[2,1024]{1,0} all-gather-done(%s)",
    "%ar = bf16[4,1024]{1,0} all-reduce(bf16[4,1024]{1,0} %z), to_apply=%add",
    "%rs = f32[2,256]{1,0} reduce-scatter(f32[4,256]{1,0} %w), dimensions={0}",
    "%m = f32[8,512]{1,0} multiply(%a, %b)",
])


def test_reference_hlo_parses_to_the_payloads():
    # the async pair is counted once, on its -start, as its result tuple
    got = jroofline.collective_bytes(HLO)
    assert got["all-reduce"] == PAYLOADS["all-reduce"]
    assert got["reduce-scatter"] == PAYLOADS["reduce-scatter"]
    assert got["all-gather"] == 8 * 512 * 4 + 2 * 2 * 1024 * 2
    assert roofline.wire_bytes(PAYLOADS) == jroofline.wire_bytes(PAYLOADS)


@pytest.mark.parametrize("per_device", [True, False])
@pytest.mark.parametrize("cost,model_flops", [
    ({"flops": 3.2e12, "bytes accessed": 4.1e9}, 9.6e14),
    ({"flops": 1e9, "bytes accessed": 7e11}, None),
    ({"flops": 5e10, "bytes accessed": 1e8}, 1e13),
])
def test_analyze_is_the_references(cost, model_flops, per_device):
    # the reference counts the async all-gather's tuple: feed the port
    # the payloads that text carries
    coll = jroofline.collective_bytes(HLO)
    want = jroofline.analyze("cell", cost=cost, hlo_text=HLO, chips=256,
                             model_flops=model_flops,
                             per_device_module=per_device).to_json()
    got = roofline.analyze("cell", cost=cost, collectives=coll, chips=256,
                           model_flops=model_flops,
                           per_device_module=per_device).to_json()
    assert got == want
    assert got["dominant"] in ("compute", "memory", "collective")


# -- perf -----------------------------------------------------------------------


def _reference_cells() -> dict:
    code = ("import json, dataclasses\n"
            "from repro.launch import perf\n"
            "print(json.dumps({c: [a, s, [dataclasses.asdict(v) for v in vs]]"
            " for c, (a, s, vs) in perf.CELLS.items()}))\n")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.splitlines()[-1])


def _jsonable(x):
    return json.loads(json.dumps(x))


def test_cells_are_the_references():
    want = _reference_cells()
    got = {c: [a, s, [dataclasses.asdict(v) for v in vs]]
           for c, (a, s, vs) in perf.CELLS.items()}
    assert _jsonable(got) == want
    assert _jsonable(perf.PURE_DP_RULES) == _jsonable(
        {k: v for k, v in perf.PURE_DP_RULES.items()})
    assert perf.build_parser().get_default("out_dir") == \
        "build/repro_torch/perf"


def _reference_decisions(arch, shape, variants) -> list[bool]:
    """The reference's accept/reject sequence from its cost model alone,
    the single mesh's plan, stacked as its ``run`` stacks accepted
    variants."""
    def step(cfg_over, plan_over):
        cfg = dataclasses.replace(jconfigs.get_config(arch),
                                  attention_impl="chunked", **cfg_over)
        plan = jcostmodel.ParallelismPlan(
            dp=16, tp=16, remat=cfg.remat,
            kv_cache_bytes=1 if cfg.kv_cache_dtype == "int8" else 2)
        for k, v in plan_over.items():
            setattr(plan, k, v)
        return jcostmodel.cell_cost(cfg, JSHAPES[shape], plan).step_s()

    cur_cfg, cur_plan = {}, {}
    cur = step(cur_cfg, cur_plan)
    out = []
    for v in variants:
        cfg, plan = {**cur_cfg, **(v.cfg or {})}, {**cur_plan,
                                                    **(v.plan or {})}
        new = step(cfg, plan)
        accept = new < cur * 0.999
        out.append(accept)
        if accept:
            cur, cur_cfg, cur_plan = new, cfg, plan
    return out


def _analytic_run_cell(arch, shape_name, mesh_name, out_dir, *, rules=None,
                       cfg_overrides=None, plan_overrides=None,
                       tag="baseline"):
    """``dryrun.run_cell``'s record priced by the analytic model alone
    (no trace), on the mesh's plan."""
    assert mesh_name == "single"
    cfg = dataclasses.replace(configs.get_config(arch),
                              attention_impl="chunked",
                              **(cfg_overrides or {}))
    plan = costmodel.ParallelismPlan(
        dp=16, tp=16, remat=cfg.remat,
        kv_cache_bytes=1 if cfg.kv_cache_dtype == "int8" else 2)
    for k, v in (plan_overrides or {}).items():
        setattr(plan, k, v)
    r = costmodel.cell_cost(cfg, SHAPES[shape_name], plan).to_json()
    return {"roofline": r, "roofline_compiled": {"wire_bytes": 0.0,
                                                 "coll_payload": {}}}


def test_decisions_are_the_references(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(dryrun, "run_cell", _analytic_run_cell)
    results = perf.run("single", str(tmp_path))
    capsys.readouterr()
    assert set(results) == set(perf.CELLS)
    for cell, (arch, shape, variants) in perf.CELLS.items():
        got = [e["accepted"] for e in results[cell]["log"][1:]]
        assert got == _reference_decisions(arch, shape, variants), cell
    assert (tmp_path / "log_single.json").exists()


def test_run_hillclimbs_a_cell_on_the_tiny_mesh(tmp_path, capsys):
    cell = "mistral-large-123b__decode_32k"
    arch = perf.CELLS[cell][0]
    small = {k: v for k, v in vars(configs.get_smoke_config(arch)).items()
             if k in ("num_layers", "d_model", "d_ff", "vocab_size",
                      "num_heads", "num_kv_heads", "head_dim")}
    res = perf.run("tiny", str(tmp_path), cells={cell: perf.CELLS[cell]},
                   cfg_overrides=small)[cell]
    out = capsys.readouterr().out
    assert f"=== {cell} [tiny] ===" in out and f"TOTAL {cell}:" in out
    log = res["log"]
    assert [e["variant"] for e in log] == ["baseline"] + [
        v.name for v in perf.CELLS[cell][2]]
    for e in log[1:]:
        assert e["accepted"] == (e["step_after_s"]
                                 < e["step_before_s"] * 0.999)
        assert e["compiled_collectives"] is not None
    assert res["total_gain"] >= 1.0
    names = sorted(p.name for p in (tmp_path / "tiny").iterdir())
    assert f"{arch}__decode_32k__perf_baseline.json" in names
    assert json.loads((tmp_path / "log_tiny.json").read_text())[cell]
    assert not dist.is_initialized()
