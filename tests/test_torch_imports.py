"""The port stands alone: no module of ``src/repro_torch/``, not
``chip_smoke.py``, ``copy_sweep.py`` nor the ``examples/torch_*.py``
twins imports jax, the JAX package or its experiment package
``benchmarks``, and importing the kernels' entry points builds and loads
nothing (the build is lazy, at first launch). On a card,
``examples/torch_dissect_serve.py --quick`` runs the dissect→deploy loop
to its ``ok:`` line, and the port's harness runs Table 8 on the kernels."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "copy_sweep.py",
    ROOT / "examples" / "torch_dissect_memory.py",
    ROOT / "examples" / "torch_dissect_serve.py",
    ROOT / "examples" / "torch_fleet_serve.py",
    ROOT / "examples" / "torch_quickstart.py",
    ROOT / "examples" / "torch_sharded_serve.py",
    ROOT / "examples" / "torch_continuous_batching.py",
    ROOT / "examples" / "torch_serve_batch.py",
    ROOT / "examples" / "torch_autotune_attention.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "benchmarks")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_the_port_has_every_module_experiment_and_example():
    """Every module of ``src/repro`` has a counterpart under the same name
    in ``src/repro_torch`` (the batched engine's ``core/cachesim_jax.py``
    is ``core/cachesim_torch.py``), but ``jaxcache.py``, the XLA compile
    cache: the port compiles nothing through XLA, and its nvcc builds are
    cached by source hash in ``kernels/_build.py``. Every module of the
    experiment package ``benchmarks/`` has one in
    ``repro_torch/benchmarks/``, every example a ``torch_`` twin, and
    every port file is walked."""
    ref = {p.relative_to(ROOT / "src" / "repro")
           for p in (ROOT / "src" / "repro").rglob("*.py")}
    port = {p.relative_to(ROOT / "src" / "repro_torch")
            for p in (ROOT / "src" / "repro_torch").rglob("*.py")}
    renamed = {"core/cachesim_jax.py": "core/cachesim_torch.py"}
    assert {renamed.get(str(p), str(p)) for p in ref} - {
        str(p) for p in port} == {"jaxcache.py"}
    bench = {p.name for p in (ROOT / "benchmarks").glob("*.py")}
    assert bench <= {p.name for p in (ROOT / "src" / "repro_torch" /
                                      "benchmarks").glob("*.py")}
    examples = {p.name for p in (ROOT / "examples").glob("*.py")
                if not p.name.startswith("torch_")}
    twins = {p.name for p in (ROOT / "examples").glob("torch_*.py")}
    assert {f"torch_{n}" for n in examples} == twins
    assert {ROOT / "examples" / n for n in twins} <= set(PORT_FILES)


def test_guard_sees_the_whole_port():
    names = {p.name for p in PORT_FILES}
    assert {"flash_attention.py", "engine.py", "serve.py", "pchase.py",
            "memcpy.py", "dbuf_copy.py", "strided.py", "rmsnorm.py",
            "classic.py", "trace.py", "cachesim.py", "devices.py",
            "bankconflict.py", "littles_law.py", "costmodel.py",
            "profile.py", "store.py", "paging.py", "chip_smoke.py",
            "copy_sweep.py", "tracecache.py", "spectrum.py", "inference.py",
            "diffing.py", "pipeline.py", "cachesim_torch.py",
            "batch_cache.py", "torch_dissect_memory.py", "tiers.py",
            "slo.py", "fleet.py", "frontend.py", "faults.py",
            "workload.py", "planner.py", "torch_dissect_serve.py",
            "torch_fleet_serve.py", "registry.py", "runner.py", "result.py",
            "report.py", "__main__.py", "autotune.py", "common.py",
            "table5_cache_params.py", "fig8_tlb.py",
            "fig14_latency_spectrum.py", "fig4_5_classic_contradiction.py",
            "fig19_kepler_modes.py", "table6_global_bw.py",
            "fig12_throughput.py", "table7_shared_bw.py",
            "table8_bank_conflict.py", "profile_roundtrip.py",
            "serve_paging.py", "serve_fleet.py", "serve_workload.py",
            "serve_tiers.py", "serve_faults.py", "ssm.py", "shapes.py",
            "deepseek_v2_lite_16b.py", "phi35_moe_42b.py", "mamba2_1p3b.py",
            "hubert_xlarge.py", "internvl2_2b.py",
            "jamba_1p5_large_398b.py", "adamw.py", "checkpoint.py",
            "fault.py", "loop.py", "compression.py", "train.py",
            "torch_quickstart.py", "sharding.py", "mesh.py",
            "serve_sharded.py", "torch_sharded_serve.py",
            "torch_continuous_batching.py", "torch_serve_batch.py",
            "dryrun.py", "perf.py", "roofline.py", "docsgen.py",
            "tpu_roofline.py", "run.py", "dtensor_tools.py",
            "torch_autotune_attention.py"} <= names
    rel = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {f"src/repro_torch/{m}.py" for m in (
        "optim/__init__", "optim/adamw", "data/__init__", "data/pipeline",
        "parallel/compression", "train/loop", "train/checkpoint",
        "train/fault", "launch/train", "parallel/sharding",
        "parallel/pipeline", "launch/mesh",
        "benchmarks/serve_sharded")} <= rel


def test_kernel_entry_points_import_lazily():
    code = (
        "import sys, json\n"
        "import repro_torch.kernels.ops, repro_torch.launch.serve\n"
        "import repro_torch.core.pchase, repro_torch.core.classic\n"
        "import repro_torch.serve.engine, repro_torch.profile\n"
        "import repro_torch.serve, repro_torch.serve.faults\n"
        "import repro_torch.core.cachesim_torch, repro_torch.core.inference\n"
        "import repro_torch.bench, repro_torch.bench.__main__\n"
        "import repro_torch.launch.train, repro_torch.train.checkpoint\n"
        "import repro_torch.optim, repro_torch.parallel.compression\n"
        "import repro_torch.data.pipeline, repro_torch.train.fault\n"
        "repro_torch.bench.discover()\n"
        "from repro_torch.kernels import _build, flash_attention, pchase, "
        "memcpy, dbuf_copy, strided, rmsnorm, batch_cache\n"
        "mods = (flash_attention, pchase, memcpy, dbuf_copy, strided, "
        "rmsnorm, batch_cache)\n"
        "print(json.dumps({'mods': [m for m in ('triton', "
        "'torch.utils.cpp_extension', 'jax', 'repro') if m in sys.modules],"
        " 'libs': len(_build._libs), 'lib': all(m._lib is None "
        "for m in mods)}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"mods": [], "libs": 0, "lib": True}


@pytest.mark.gpu
def test_dissect_serve_example_runs_on_the_card():
    """The dissect→deploy loop on the card: the torch engine dissects
    GTX980, a replica is bound to the fresh profile and serves."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch sees no CUDA device)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable,
                          str(ROOT / "examples" / "torch_dissect_serve.py"),
                          "--quick"], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1].startswith("ok: dissect-on-start bound the fleet")
    assert "engine=torch" in lines[0] and "pages leaked: 0" in lines[-2]


@pytest.mark.gpu
def test_bench_runs_table8_on_the_card(tmp_path):
    """The port's harness on the card: Table 8 on every device, the
    tpu_v5e record checking the CUDA strided kernel against its oracle."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch sees no CUDA device)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = tmp_path / "table8.json"
    p = subprocess.run([sys.executable, "-m", "repro_torch.bench", "run",
                        "--only", "table8_bank_conflict", "--device",
                        "tpu_v5e", "--strict", "--no-csv", "--out",
                        str(out)], env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr
    payload = json.loads(out.read_text())
    assert payload["summary"]["PASS"] == 1
    assert payload["kernel_launches"]["strided"] == 6
    metrics = {m["name"]: m for m in payload["records"][0]["metrics"]}
    assert metrics["strided_kernel_matches_oracle"]["measured"] is True
