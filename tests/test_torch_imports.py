"""The port stands alone: no module of ``src/repro_torch/``, not
``chip_smoke.py``, ``copy_sweep.py`` nor ``examples/torch_dissect_memory.py``
imports jax or the JAX package, and importing the
kernels' entry points builds and loads nothing (the build is lazy, at
first launch)."""

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
    ROOT / "examples" / "torch_dissect_memory.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


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


def test_guard_sees_the_whole_port():
    names = {p.name for p in PORT_FILES}
    assert {"flash_attention.py", "engine.py", "serve.py", "pchase.py",
            "memcpy.py", "dbuf_copy.py", "strided.py", "rmsnorm.py",
            "classic.py", "trace.py", "cachesim.py", "devices.py",
            "bankconflict.py", "littles_law.py", "costmodel.py",
            "profile.py", "store.py", "paging.py", "chip_smoke.py",
            "copy_sweep.py", "tracecache.py", "spectrum.py", "inference.py",
            "diffing.py", "pipeline.py", "cachesim_torch.py",
            "batch_cache.py", "torch_dissect_memory.py"} <= names


def test_kernel_entry_points_import_lazily():
    code = (
        "import sys, json\n"
        "import repro_torch.kernels.ops, repro_torch.launch.serve\n"
        "import repro_torch.core.pchase, repro_torch.core.classic\n"
        "import repro_torch.serve.engine, repro_torch.profile\n"
        "import repro_torch.core.cachesim_torch, repro_torch.core.inference\n"
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
