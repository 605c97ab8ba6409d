"""The port's dissection harness (``repro_torch.bench`` and the experiments
of ``repro_torch/benchmarks/``) against the JAX package's on the CPU.

Both harnesses run in this process, the reference on CPU jax (its Pallas
kernels in interpret mode) and the port on ``torch_device="cpu"``, where
its kernels' wrappers take their plain versions. Every experiment x
device record of the port must equal the reference's metric for metric,
in the order of the metrics and in name, measured, expected, cmp, tol,
unit and verdict; only ``us``, ``elapsed_s`` and the metrics that time
their run (``chip_smoke.BENCH_TIMING_METRICS``, the list the card's bench
phase masks) are masked. The serving experiments run on the reference's
weights, carried across by ``params_from_jax`` through each experiment's
``_params`` seam, so every token-derived metric must equal too. Then the
harness itself (registry, verdicts, artifacts, runner, report, the CLI),
as ``tests/test_bench.py`` holds the reference's.
"""

import dataclasses
import functools
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.bench import registry as jreg
from repro.bench import report as jreport
from repro.bench import result as jresult
from repro.bench import runner as jrunner
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.bench import __main__ as cli
from repro_torch.bench import registry as reg
from repro_torch.bench import report, runner
from repro_torch.bench.registry import Context
from repro_torch.bench.result import (DEVIATION, ERROR, INFO, PASS,
                                      ExperimentRecord, Metric, info,
                                      load_artifact, summarize,
                                      write_artifact)
from repro_torch.bench.runner import (RunOptions, records_to_rows,
                                      run_experiments)
from repro_torch.core import devices
from repro_torch.core import tracecache
from repro_torch.models.convert import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
#: the reference's experiments that the port does not carry: none since
#: the TPU roofline came with the dry-run
NOT_PORTED = ()
SERVING = ("serve_paging", "serve_fleet", "serve_workload", "serve_tiers",
           "serve_faults")


def _smoke():
    """``chip_smoke.py`` as a module (its top level imports the standard
    library only)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()
reg.discover()
PAIRS = [(e.name, d) for e in reg.all_experiments() for d in e.devices]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models here are tiny: one intra-op thread for torch keeps a
    parallel test run from oversubscribing the host's cores. Results do
    not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_params(cfg):
    jcfg = JModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)})
    return jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.key(0)))


def _masked(rec) -> dict:
    return SMOKE.masked_record(rec.to_json())


def _reference(quick: bool, names) -> dict:
    jreg.discover()
    recs = jrunner.run_experiments(jrunner.RunOptions(
        quick=quick, names=tuple(names)))
    return {(r.experiment, r.device): r for r in recs}


def _port(quick: bool, names, calls: list | None = None) -> dict:
    """The port's records on the CPU, its serving experiments on the
    reference's weights (each call of a ``_params`` seam is appended to
    ``calls``)."""
    def ref_params(name):
        def params(cfg, device):
            calls.append(name)
            return params_from_jax(_jax_params(cfg), cfg).to(device)
        return params

    with pytest.MonkeyPatch.context() as mp:
        for name in SERVING:
            mp.setattr(f"repro_torch.benchmarks.{name}._params",
                       ref_params(name))
        recs = run_experiments(RunOptions(quick=quick, names=tuple(names),
                                          torch_device="cpu"))
    return {(r.experiment, r.device): r for r in recs}


@pytest.fixture(scope="module")
def quick_records(tmp_path_factory):
    names = sorted({n for n, _ in PAIRS})
    calls: list[str] = []
    # tpu_roofline reads dry-run records where the reference reads its
    # own; with none on either side both fall back to the analytic cells
    from repro_torch.benchmarks import tpu_roofline
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpu_roofline, "DRYRUN_ROOT",
                   str(tmp_path_factory.mktemp("no_dryrun")))
        port = _port(True, names, calls)
    return _reference(True, names), port, calls


def test_the_port_registers_the_reference_s_experiments_but_two():
    """All of the reference's experiments but ``NOT_PORTED`` (none since
    the dry-run came; the name is kept)."""
    jreg.discover()
    want = [(e.name, d) for e in jreg.all_experiments() for d in e.devices
            if e.name not in NOT_PORTED]
    assert PAIRS == want and len(PAIRS) == 37
    for e in reg.all_experiments():
        j = jreg.get(e.name)
        assert (e.title, e.section, e.artifact, e.tags, dict(e.expected)) \
            == (j.title, j.section, j.artifact, j.tags, dict(j.expected))


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_quick_record_matches_the_reference(pair, quick_records):
    ref, port, _ = quick_records
    assert port[pair].verdict == PASS, port[pair].error
    assert _masked(port[pair]) == _masked(ref[pair])


def test_serving_experiments_ran_on_the_reference_s_weights(quick_records):
    *_, calls = quick_records
    assert sorted(set(calls)) == sorted(SERVING)


@pytest.mark.parametrize("name", ["table6_global_bw",
                                  "table8_bank_conflict"])
def test_full_mode_kernel_record_matches_the_reference(name):
    """Outside quick mode the accelerator record drives a kernel: memcpy
    timed, the strided gather against its oracle (Pallas in interpret
    mode in the reference, the plain versions here)."""
    pair = (name, "tpu_v5e")
    ref, port = _reference(False, [name])[pair], _port(False, [name])[pair]
    assert port.verdict == PASS, port.error
    assert _masked(port) == _masked(ref)
    got = {m.name: m for m in port.metrics}
    if name == "table8_bank_conflict":
        assert got["strided_kernel_matches_oracle"].measured is True
        assert "cpu" in got["strided_kernel_matches_oracle"].detail
    else:
        assert got["host_memcpy_gbps"].measured > 0
        assert "on cpu by the plain version" in got["host_memcpy_gbps"].detail


def test_speedup_race_runs_on_the_cpu():
    """The race runs on the CPU too, as the reference races wherever its
    engine resolves: the reference's name, comparison and limit, and a
    positive ratio. Its verdict is timing under a loaded host, so it is
    not asserted."""
    from repro_torch.benchmarks import profile_roundtrip
    ctx = Context(device=devices.get_device("GTX980"),
                  torch_device=torch.device("cpu"))
    m = profile_roundtrip._engine_speedup_metric(ctx)
    assert (m.name, m.cmp, m.expected) == ("batched_engine_speedup", "ge", 10)
    assert m.measured > 0 and m.us > 0
    assert "0 scan launches on cpu" in m.detail


# -- the harness itself -------------------------------------------------------


@pytest.fixture
def scratch_registry(monkeypatch):
    """An empty registry the test can populate without global side effects."""
    monkeypatch.setattr(reg, "REGISTRY", {})
    return reg.REGISTRY


def _register(name, fn=None, devices_=("GTX780",), **kw):
    fn = fn or (lambda ctx: [Metric("m", 1, 1, cmp="eq")])
    return reg.experiment(name=name, title=kw.pop("title", name),
                          section=kw.pop("section", "§0"),
                          artifact=kw.pop("artifact", "Fig 0"),
                          devices=devices_, **kw)(fn)


def test_register_get_and_idempotent_reimport(scratch_registry):
    def fn(ctx):
        return []

    _register("exp_a", fn=fn)
    _register("exp_a", fn=fn)          # idempotent re-registration
    assert reg.get("exp_a").name == "exp_a"
    assert [e.name for e in reg.all_experiments()] == ["exp_a"]
    with pytest.raises(ValueError, match="already registered"):
        _register("exp_a", fn=lambda ctx: [])
    with pytest.raises(KeyError, match="unknown device"):
        _register("exp_b", devices_=("GTX9999",))
    with pytest.raises(KeyError, match="unknown experiment"):
        reg.get("nope")


def test_select_filters(scratch_registry):
    _register("exp_a", devices_=("GTX780",), tags=("cache",))
    _register("exp_b", devices_=("GTX980",), section="§4.4")
    assert [e.name for e in reg.select(device="GTX980")] == ["exp_b"]
    assert [e.name for e in reg.select(tag="cache")] == ["exp_a"]
    assert [e.name for e in reg.select(section="4.4")] == ["exp_b"]
    with pytest.raises(KeyError, match="unknown experiments"):
        reg.select(names=["nope"])


def test_discover_skips_the_helpers_and_registers_all_fifteen():
    """All the port's experiments: seventeen since tpu_roofline (the name
    is kept); ``run``, the CSV wrapper, registers nothing."""
    mods = reg.discover()
    assert "common" not in mods and "run" not in mods and len(mods) == 17
    assert sorted(mods) == sorted(reg.REGISTRY)
    for e in reg.all_experiments():
        assert e.devices, e.name
        for d in e.devices:
            devices.get_device(d)


def test_context_runs_on_the_card_unless_told():
    entry = devices.get_device("GTX780")
    assert Context(device=entry,
                   torch_device=torch.device("cpu")).torch_device.type == "cpu"
    if torch.cuda.is_available():
        assert Context(device=entry).torch_device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            Context(device=entry)


@pytest.mark.parametrize("metric,verdict", [
    (dict(measured=4, expected=4, cmp="eq"), PASS),
    (dict(measured=4, expected=5, cmp="eq"), DEVIATION),
    (dict(measured="a", expected="a", cmp="eq"), PASS),
    (dict(measured=104.9, expected=100.0, tol=0.05), PASS),
    (dict(measured=106.0, expected=100.0, tol=0.05), DEVIATION),
    (dict(measured=0.04, expected=0.0, tol=0.05), PASS),
    (dict(measured=90, expected=100, cmp="le", tol=0), PASS),
    (dict(measured=110, expected=100, cmp="le", tol=0), DEVIATION),
    (dict(measured=110, expected=100, cmp="ge", tol=0), PASS),
    (dict(measured=2.5, expected=[2.0, 3.5], cmp="range"), PASS),
    (dict(measured=3.6, expected=[2.0, 3.5], cmp="range"), DEVIATION),
    (dict(measured="whatever", cmp="info"), INFO),
    (dict(measured="nan?", expected=1.0, cmp="close"), DEVIATION),
    (dict(measured=np.int64(3), expected=np.float32(3.0), cmp="eq"), PASS),
])
def test_verdict_is_the_reference_s(metric, verdict):
    got = Metric("m", **metric)
    assert got.verdict == verdict == jresult.Metric("m", **metric).verdict
    assert got.to_json() == jresult.Metric("m", **metric).to_json()


def test_metric_checks_its_rule_and_expectation():
    with pytest.raises(ValueError, match="requires an expected"):
        Metric("m", 1)
    with pytest.raises(ValueError, match="unknown cmp"):
        Metric("m", 1, 1, cmp="near")


def test_record_verdict_folding():
    ok = Metric("a", 1, 1, cmp="eq")
    bad = Metric("b", 1, 2, cmp="eq")
    rec = ExperimentRecord("e", "d", "§", "T", [ok, info("c", 0)])
    assert rec.verdict == PASS
    rec = ExperimentRecord("e", "d", "§", "T", [ok, bad])
    assert rec.verdict == DEVIATION
    assert [m.name for m in rec.deviations] == ["b"]
    assert ExperimentRecord("e", "d", "§", "T", [info("c", 0)]).verdict == INFO
    rec = ExperimentRecord("e", "d", "§", "T", [], error="boom")
    assert rec.verdict == ERROR
    assert summarize([rec]) == {PASS: 0, DEVIATION: 0, INFO: 0, ERROR: 1}


@pytest.mark.parametrize("writer,loader", [
    (write_artifact, jresult.load_artifact),
    (jresult.write_artifact, load_artifact)], ids=["port-to-jax",
                                                   "jax-to-port"])
def test_an_artifact_of_either_package_loads_in_the_other(tmp_path, writer,
                                                           loader):
    mod = sys.modules[writer.__module__]
    recs = [
        mod.ExperimentRecord(
            "exp_a", "GTX780", "§4.4", "Fig 8",
            [mod.Metric("reach", 130, 130, cmp="eq", unit="MB"),
             mod.Metric("eff", 0.75, [0.65, 0.85], cmp="range"),
             mod.info("curve", "[1, 2, 3]")],
            elapsed_s=1.25),
        mod.ExperimentRecord("exp_b", "tpu_v5e", "§5", "Table 6", [],
                             error="Traceback: ..."),
    ]
    path = str(tmp_path / "a.json")
    payload = writer(recs, path, extra={"quick": True})
    loaded = loader(path)
    assert [r.to_json() for r in loaded] == [r.to_json() for r in recs]
    assert payload["schema"] == "repro.bench/v1"
    assert payload["summary"] == {PASS: 1, DEVIATION: 0, INFO: 0, ERROR: 1}
    raw = json.loads(open(path).read())
    assert raw["records"][0]["verdict"] == PASS
    assert raw["records"][0]["metrics"][0]["verdict"] == PASS
    assert raw["quick"] is True


def test_schema_mismatch_rejected(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text('{"schema": "other/v9", "records": []}')
    with pytest.raises(ValueError, match="unknown schema"):
        load_artifact(str(p))


def test_record_seed_is_the_reference_s():
    for base, exp, dev in ((0, "fig8_tlb", "GTX780"), (7, "serve_fleet",
                                                        "tpu_v5e")):
        assert runner.record_seed(base, exp, dev) == jrunner.record_seed(
            base, exp, dev)


def test_runner_runs_each_device_and_counts_launches(scratch_registry):
    calls = []

    def fn(ctx):
        calls.append((ctx.device.name, ctx.quick, ctx.seed,
                      ctx.torch_device.type))
        return [Metric("one", 1, 1, cmp="eq")]

    _register("exp_a", fn=fn, devices_=("GTX780", "GTX980"))
    launches: dict[str, int] = {}
    recs = run_experiments(RunOptions(quick=True, torch_device="cpu"),
                           launches=launches)
    assert [(r.experiment, r.device) for r in recs] == [
        ("exp_a", "GTX780"), ("exp_a", "GTX980")]
    assert calls == [(d, True, runner.record_seed(0, "exp_a", d), "cpu")
                     for d in ("GTX780", "GTX980")]
    assert all(r.verdict == PASS for r in recs)
    assert launches == dict.fromkeys(runner.KERNELS, 0)
    recs = run_experiments(RunOptions(device="GTX980", torch_device="cpu"))
    assert [(r.experiment, r.device) for r in recs] == [("exp_a", "GTX980")]


def test_experiment_error_is_captured(scratch_registry):
    def boom(ctx):
        raise RuntimeError("probe failed")

    _register("exp_a", fn=boom)
    recs = run_experiments(RunOptions(torch_device="cpu"))
    assert recs[0].verdict == ERROR
    assert "probe failed" in recs[0].error


def test_records_to_rows_csv_shape(scratch_registry):
    _register("exp_a", fn=lambda ctx: [
        Metric("m", 130, 130, cmp="eq", unit="MB", us=12.5),
        info("i", "x,y")])
    rows = records_to_rows(run_experiments(RunOptions(torch_device="cpu")))
    assert rows[0][0] == "exp_a/GTX780/m"
    assert rows[0][1] == 12.5
    assert "PASS" in rows[0][2]
    assert "," not in rows[1][2]          # CSV-safe derived field


def test_render_report_contains_verdicts(scratch_registry):
    _register("exp_a", fn=lambda ctx: [
        Metric("m", 2, 1, cmp="eq", detail="off by one")])
    text = report.render_report(run_experiments(
        RunOptions(torch_device="cpu")))
    assert "DEVIATION" in text
    assert "exp_a" in text and "GTX780" in text
    assert "m: 2 vs 1" in text


def test_experiments_doc_from_metadata(scratch_registry):
    _register("exp_a", expected={"claim": "16 KB"}, tags=("cache",))
    text = report.experiments_doc()
    assert "GENERATED FILE" in text and "repro_torch.bench" in text
    assert "`exp_a`" in text and "16 KB" in text
    assert "tpu_v5e" in text              # device table


def test_report_of_the_committed_artifact_is_the_reference_s():
    path = str(ROOT / "experiments" / "bench" / "latest.json")
    want = jreport.render_report(jresult.load_artifact(path))
    assert report.render_report(load_artifact(path)) == want


# -- the CLI ------------------------------------------------------------------


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.bench", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.fixture
def trace_root(tmp_path, monkeypatch):
    """The profile commands' trace cache under ``tmp_path``, and off again
    after the test."""
    monkeypatch.setattr(tracecache, "DEFAULT_ROOT", str(tmp_path / "traces"))
    yield tmp_path / "traces"
    tracecache.configure(None)


@pytest.fixture
def experiments_unchanged():
    """No file under experiments/ or docs/ changes while the test runs."""
    before = SMOKE.tree_state("experiments", "docs")
    yield
    assert SMOKE.tree_state("experiments", "docs") == before


def test_cli_quick_run_in_a_spawned_pool_is_the_serial_run(
        tmp_path, experiments_unchanged):
    """37 PASS through ``python -m repro_torch.bench`` on two spawned
    workers, the same records in the same order as a serial run."""
    out = tmp_path / "quick.json"
    p = _cli("run", "--quick", "--strict", "--torch-device", "cpu",
             "--no-csv", "--jobs", "2", "--no-trace-cache", "--out",
             str(out))
    assert p.returncode == 0, p.stderr
    assert "37 PASS, 0 DEVIATION, 0 ERROR" in p.stderr
    payload = json.loads(out.read_text())
    assert payload["summary"] == {PASS: 37, DEVIATION: 0, INFO: 0, ERROR: 0}
    assert payload["kernel_launches"] == dict.fromkeys(
        runner.KERNELS, 0)
    serial = run_experiments(RunOptions(quick=True, torch_device="cpu"))
    assert [_masked(r) for r in load_artifact(str(out))] == [
        _masked(r) for r in serial]


def test_cli_run_without_a_torch_device_needs_the_card(experiments_unchanged):
    if torch.cuda.is_available():
        pytest.skip("a card is present, so run goes to it")
    p = _cli("run", "--only", "fig19_kepler_modes", "--quick")
    assert p.returncode != 0
    assert "no CUDA card" in p.stderr


def test_cli_list_report_and_docs(tmp_path, capsys, monkeypatch,
                                  experiments_unchanged):
    assert cli.main(["list"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("17 experiments (17 registered):")
    assert "table5_cache_params" in out and "tpu_roofline" in out
    path = str(ROOT / "experiments" / "bench" / "latest.json")
    assert cli.main(["report", path, "-o", str(tmp_path / "r.md")]) == 0
    assert (tmp_path / "r.md").read_text() == jreport.render_report(
        jresult.load_artifact(path))
    monkeypatch.setattr(cli, "DOCS_ROOT", str(tmp_path / "docs"))
    assert cli.main(["docs"]) == 0
    assert cli.main(["docs", "--check"]) == 0
    assert sorted(p.name for p in (tmp_path / "docs").iterdir()) == [
        "cli.md", "experiments.md", "profiles.md", "serving.md"]


def test_cli_run_writes_its_report_and_fails_strict_on_a_deviation(
        tmp_path, monkeypatch, capsys, experiments_unchanged):
    out, rep = tmp_path / "a.json", tmp_path / "a.md"
    argv = ["run", "--only", "fig19_kepler_modes", "--quick", "--strict",
            "--torch-device", "cpu", "--jobs", "1", "--no-trace-cache",
            "--out", str(out), "--report", str(rep)]
    assert cli.main(argv) == 0
    assert "name,us_per_call,derived" in capsys.readouterr().out
    assert [(r.experiment, r.device, r.verdict)
            for r in load_artifact(str(out))] == [
        ("fig19_kepler_modes", "GTX780", PASS)]
    assert "PASS" in rep.read_text()
    from repro_torch.benchmarks import fig19_kepler_modes as fig19
    monkeypatch.setattr(fig19, "STRIDES",             # one win fewer
                        [s for s in fig19.STRIDES if s != 6])
    assert cli.main(argv) == 1
    assert "DEVIATION: fig19_kepler_modes × GTX780: 8B_mode_wins" in \
        capsys.readouterr().err


def test_cli_profile_dissect_writes_only_where_it_is_told(
        tmp_path, trace_root, capsys, experiments_unchanged):
    default = Path(cli.PROFILE_ROOT) / "GTX980.json"
    seen = default.stat().st_mtime_ns if default.exists() else None
    out = tmp_path / "GTX980.json"
    assert cli.main(["profile", "dissect", "GTX980", "--engine", "vector",
                     "--out", str(out)]) == 0
    assert f"# profile -> {out}" in capsys.readouterr().err
    assert (default.stat().st_mtime_ns if default.exists() else None) == seen
    from repro_torch import profile as P
    prof = P.load_profile(str(out))
    assert prof.device == "GTX980" and prof.engine == "vector"
    assert all(r.ok for r in P.diff_profiles(prof,
                                             P.published_profile("GTX980")))


def test_cli_profile_show_diff_and_validate_the_committed_profiles(
        trace_root, capsys, experiments_unchanged):
    assert cli.main(["profile", "diff", "GTX980"]) == 0
    assert "Profile diff: GTX980" in capsys.readouterr().out
    assert cli.main(["profile", "show", "TeslaV100"]) == 0
    assert "latency/" in capsys.readouterr().out
    assert cli.main(["profile", "validate"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 5 and all(ln.startswith("ok ") for ln in lines)
    assert cli.main(["profile", "diff"]) == 2
