"""The manifest keeps to the benchmark's contract: names, units and
lengths; every configuration, mix and cell file in place; each per-layer
metric's cells report the end-to-end metric it moves; every cell reports
``setup_s``, another end-to-end metric and a per-layer one."""

import json
import re
from pathlib import Path

import pytest

from perfbench import manifest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["perfbench"]
    assert all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32
    assert BENCH["command"][1].startswith("perfbench/")


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_plain(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_every_entry_has_exactly_its_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                         "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                         "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_units_and_words(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    for key in ("layer",):
        if key in metric:
            assert 1 <= len(metric[key]) <= 200 and "\n" not in metric[key]


def test_setup_s_is_bounded_at_a_quarter():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] == 0.25 and "workloads" not in setup[0]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_and_reports(cell):
    c = manifest.load_cell(cell)
    assert c.spec["config"] == c.entry["config"]
    assert c.spec["mix"] == c.entry["traffic"]
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
    assert set(c.spec["limits"])


def test_per_layer_names_its_cells_and_layers_agree():
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= set(CELLS)
        base = m["name"].split(".")[0]
        layers.setdefault(base, set()).add(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert all(len(v) == 1 for v in layers.values()), layers


def test_every_config_is_used_and_lists_its_cuts():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("perfbench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        assert len(c["source"]) <= 200
        assert not any(k.endswith(("_dim", "_rank", "_size")) or "experts"
                       in k for k in c["reduced"])


def test_roofline_and_mfu_shares_are_percent():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"
