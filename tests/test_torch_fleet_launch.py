"""The port's fleet entry points against the JAX package's on the CPU.

``python -m repro_torch.launch.serve --engine fleet`` (and ``--plan``)
must print what ``python -m repro.launch.serve`` prints, line for line,
once wall times and the dissection engine's name are masked. Both run in
this process through ``main(argv)``; the port's launcher is handed the
reference's weights (carried across by ``params_from_jax``) in place of
its own random ones, so the sampled streams agree too. The examples
``torch_dissect_serve.py`` and ``torch_fleet_serve.py`` are run beside
their JAX twins: the same measured structures, page lengths, pools and
token counts.
"""

import re
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
BASE = ["--arch", "granite-8b", "--smoke"]

#: the launcher cases: the listed flags, at a size that keeps the file
#: inside its time budget
CASES = {
    "mixed": ["--engine", "fleet", "--replicas", "2",
              "--fleet-profiles", "tpu_v5e,TeslaV100", "--requests", "8"],
    "dissect_on_start": ["--engine", "fleet", "--dissect-on-start", "GTX980",
                         "--requests", "6"],
    "faults": ["--engine", "fleet", "--replicas", "2", "--faults", "0",
               "--requests", "8", "--max-len", "48"],
    "workload_replay": ["--engine", "fleet", "--replicas", "2",
                        "--workload", "chat", "--workload-replay",
                        "--horizon", "16", "--max-len", "48"],
    "tiers_auto": ["--engine", "fleet", "--replicas", "2",
                   "--fleet-tiers", "auto", "--requests", "8"],
    "plan": ["--plan", "--workload", "rag",
             "--fleet-profiles", "tpu_v5e,TeslaV100,GTX980",
             "--fleet-tiers", "auto"],
}

_MASKS = [
    (re.compile(r"\d[\d,]*(\.\d+)? ?(ms|s)\b"), "<t>"),
    (re.compile(r"\([\d,]+ tok/s wall\)"), "(<rate>)"),
    (re.compile(r"engine=(torch|jax)\b"), "engine=<e>"),
    (re.compile(r"\[\d+\.\d+s\]"), "[<t>]"),
]


def _mask(text: str) -> list[str]:
    lines = []
    for ln in text.splitlines():
        for pat, sub in _MASKS:
            ln = pat.sub(sub, ln)
        lines.append(ln)
    return lines


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models here are tiny: one intra-op thread for torch keeps a
    parallel test run from oversubscribing the host's cores (2.5x faster
    under ``-n 4``). Results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smoke_params():
    jcfg = jconfigs.get_smoke_config("granite-8b")
    jparams = JT.init_params(jcfg, jax.random.key(0))
    return params_from_jax(jax.tree.map(np.asarray, jparams),
                           configs.get_smoke_config("granite-8b"))


@pytest.mark.parametrize("name", list(CASES))
def test_fleet_launcher_prints_what_the_reference_prints(
        name, smoke_params, monkeypatch, capsys):
    argv = BASE + CASES[name]
    jserve.main(argv)
    want = capsys.readouterr().out
    monkeypatch.setattr(serve.T, "init_params",
                        lambda cfg, gen, device: smoke_params)
    before = fa.launches
    out = serve.main(argv + ["--device", "cpu"])
    assert fa.launches == before
    got = capsys.readouterr().out
    assert _mask(got) == _mask(want)
    assert got.strip()
    if name == "dissect_on_start":
        assert "engine=torch" in got and "engine=jax" in want
    if name == "faults":
        assert "campaign replay verified" in got
        assert out[0].log == out[1].log
    if name == "workload_replay":
        assert "workload replay verified" in got
    if name == "tiers_auto":
        assert out["fleet"].tiered and out["fleet"].stats()["handoffs"] > 0
    if name == "mixed":
        assert "sample stream:" in got


def test_plan_needs_no_parameters_and_no_device(monkeypatch, capsys):
    """``--plan`` without ``--device cpu`` on a host with no card: pure
    accounting, it never builds weights or asks for a device."""
    def refuse(*a, **k):
        raise AssertionError("--plan built parameters or asked for a device")

    monkeypatch.setattr(serve.T, "init_params", refuse)
    monkeypatch.setattr(serve, "resolve_device", refuse)
    plans = serve.main(BASE + ["--plan", "--fleet-profiles",
                               "tpu_v5e,TeslaV100"])
    assert len(plans) == 2 and "-- best:" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--engine", "fleet", "--dissect-on-start", "GTX980",
     "--fleet-profiles", "tpu_v5e"],
    ["--engine", "fleet", "--workload", "meteor"],
    ["--engine", "fleet", "--replicas", "3", "--fleet-profiles",
     "tpu_v5e,TeslaV100"],
], ids=["exclusive", "unknown_workload", "replica_mismatch"])
def test_fleet_launcher_errors_match_reference(argv, smoke_params,
                                               monkeypatch, capsys):
    def outcome(main, extra):
        try:
            main(BASE + argv + extra)
        except (SystemExit, ValueError) as e:
            return type(e).__name__, str(e)
        return None

    want = outcome(jserve.main, [])
    monkeypatch.setattr(serve.T, "init_params",
                        lambda cfg, gen, device: smoke_params)
    got = outcome(serve.main, ["--device", "cpu"])
    capsys.readouterr()
    assert got == want and got is not None


def test_temperature_is_accepted_as_in_the_reference():
    args = serve.build_parser().parse_args(BASE + ["--temperature", "0.7"])
    jargs = jserve.build_parser().parse_args(BASE + ["--temperature", "0.7"])
    assert args.temperature == jargs.temperature == 0.7


def test_fleet_flags_are_the_references_but_mesh_shape():
    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}

    ours, theirs = flags(serve.build_parser()), flags(jserve.build_parser())
    assert theirs - ours == set()
    assert ours - theirs == {"--device"}
    with pytest.raises(SystemExit, match="--mesh-shape 2: serve mesh "
                                         r"\(2,\) needs 2 devices, have 1"):
        serve.main(BASE + ["--engine", "fleet", "--mesh-shape", "2",
                           "--device", "cpu"])


def _run_example(path, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [str(path), *argv])
    runpy.run_path(str(path), run_name="__main__")
    return capsys.readouterr().out


@pytest.mark.parametrize("name", ["dissect_serve", "fleet_serve"])
def test_example_twin_matches_reference(name, monkeypatch, capsys):
    """The same measured structures, page_len, pool and served token
    counts as the JAX example (the tokens themselves differ: each example
    makes its own random weights)."""
    want = _run_example(ROOT / "examples" / f"{name}.py", ["--quick"],
                        monkeypatch, capsys)
    before = fa.launches
    got = _run_example(ROOT / "examples" / f"torch_{name}.py",
                       ["--quick", "--device", "cpu"], monkeypatch, capsys)
    assert fa.launches == before

    def shape(text):
        return [ln for ln in _mask(text) if "token #" not in ln]

    assert shape(got) == shape(want)
    assert got.splitlines()[-1].startswith("ok:")
    if name == "dissect_serve":
        assert "engine=torch" in got
        assert "page_len=" in got and "pages leaked: 0" in got


@pytest.mark.parametrize("name,argv", [
    ("continuous_batching", []),
    ("serve_batch", ["--engine", "dense", "--requests", "4",
                     "--max-len", "48"]),
    ("serve_batch", ["--engine", "paged", "--requests", "4",
                     "--max-len", "48", "--slots", "2"]),
], ids=["continuous_batching", "serve_batch_dense", "serve_batch_paged"])
def test_serving_example_twin_prints_the_reference_tokens(
        name, argv, smoke_params, monkeypatch, capsys):
    """The twins of ``examples/continuous_batching.py`` and
    ``examples/serve_batch.py`` (over the launcher) on the reference's
    weights print the reference's lines, its tokens included, once wall
    times and the port's ``device=`` are masked."""
    want = _run_example(ROOT / "examples" / f"{name}.py", argv,
                        monkeypatch, capsys)
    monkeypatch.setattr(serve.T, "init_params",
                        lambda cfg, gen, device: smoke_params)
    before = fa.launches
    got = _run_example(ROOT / "examples" / f"torch_{name}.py",
                       [*argv, "--device", "cpu"], monkeypatch, capsys)
    assert fa.launches == before

    def lines(text):
        return _mask(re.sub(r"\(\d+\.\ds\)", "(<t>)",
                            text.replace(" device=cpu", "")))

    assert lines(got) == lines(want)
    assert ("req 0: prompt[" in got if name == "continuous_batching"
            else "sample tokens:" in got)
