"""The benchmark stands alone and is driven by its files: nothing under
``perfbench/`` imports JAX, the JAX package or its experiment package,
the references import nothing of the program, and a configuration, a
mix, a cell and a per-layer metric are found by their file names alone,
with no file of the harness edited."""

import ast
import json
import time
from pathlib import Path

import pytest
import torch

from perfbench import harness, manifest

HERE = Path(__file__).resolve().parent
SOURCES = sorted(HERE.rglob("*.py"))


def _imports(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append(node.module)
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_repro_or_benchmarks_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "repro",
                                  "benchmarks")]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_references_import_nothing_of_the_program(path):
    bad = [m for m in _imports(path) if m.split(".")[0] == "repro_torch"]
    assert not bad, f"{path.name} imports {bad}"


def test_a_new_config_mix_cell_and_metric_need_only_new_files(tiny):
    """The tiny tree's configuration, mix and cell are new names; a new
    per-layer metric is one reader file and a manifest entry."""
    root, here = tiny
    (here / "metrics" / "ticks_seen.py").write_text(
        "def read(records):\n"
        "    return float(len(records['ticks'])) if 'ticks' in records "
        "else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "ticks_seen", "unit": "ticks", "better": "higher",
        "source": "host_clock", "layer": "engine tick",
        "moves": "output_tok_s", "workloads": ["tiny-dense.open"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = manifest.load_cell("tiny-dense.open", root, here)
    assert cell.config["name"] == "tiny-dense" and cell.mix["loop"] == "open"
    assert "ticks_seen" in [m["name"] for m in cell.per_layer]
    records = {"ticks": [{}, {}, {}]}
    assert harness.per_layer(cell, records, here)["ticks_seen"] == {
        "value": 3.0, "unit": "ticks"}


def test_a_missing_cell_is_an_error(tiny):
    root, here = tiny
    with pytest.raises(KeyError):
        manifest.load_cell("no-such.cell", root, here)


def test_no_card_prints_no_result(capsys):
    """The entry exits non-zero with no result line where torch sees no
    card (here, always)."""
    from perfbench import run
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "granite-8b.chat", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out.strip() == ""


def test_the_result_line_comes_last_with_checks_last(tiny, capsys):
    root, here = tiny
    cell = manifest.load_cell("tiny-dense.open", root, here)
    result = harness.run_cell(cell, 5, 0.5, False, torch.device("cpu"),
                              time.perf_counter(), {"platform": "cpu"}, here)
    harness.emit(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check gap_max = ")
