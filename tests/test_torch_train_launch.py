"""The port's training launcher and quickstart twin against the JAX
package's on the CPU.

``python -m repro_torch.launch.train`` must print what ``python -m
repro.launch.train`` prints, line for line, once the rates and wall
times are masked. Both run in this process through ``main(argv)``; the
port's launcher is handed the reference's initial state (carried across
by ``state_from_jax``) through its ``_state`` seam, so both train the
same weights on the same batches. Every logged loss, ce and grad norm
is within 1e-5 relative of the reference's (float32 smoke configs).
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
from repro.launch import train as jtrain
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train import loop as JLoop
from repro_torch import configs
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.models.convert import state_from_jax
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import SimulatedPreemption

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-5
BASE = ["--arch", "granite-8b", "--smoke", "--steps", "20",
        "--log-every", "5"]
#: the logged numbers, compared within REL; rates and wall times, masked
_NUMBERS = re.compile(r"(loss|ce|gnorm|final_loss)=(-?[\d.]+)")
_MASKS = [(re.compile(r"tok/s=[\d,]+"), "tok/s=<r>"),
          (re.compile(r"in [\d.]+s \([\d,]+ tok/s\)"), "in <t> (<r>)")]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split(text: str):
    """(masked lines, logged numbers by name)"""
    lines, nums = [], {}
    for ln in text.splitlines():
        for name, val in _NUMBERS.findall(ln):
            nums.setdefault(name, []).append(float(val))
        ln = _NUMBERS.sub(r"\1=<x>", ln)
        for pat, sub in _MASKS:
            ln = pat.sub(sub, ln)
        lines.append(ln)
    return lines, nums


def _reference_state(monkeypatch, arch):
    def state(cfg, opt, device, compress):
        js = JLoop.init_state(jconfigs.get_smoke_config(arch),
                              JAdamWConfig(lr=opt.lr), jax.random.key(0),
                              compress=compress)
        return state_from_jax(jax.tree.map(np.asarray, js), cfg).to(device)
    monkeypatch.setattr(train, "_state", state)


def _logged(module, argv, monkeypatch):
    """Every step's metrics as the launcher's run_training saw them."""
    seen = []
    real = module.run_training

    def spy(*a, on_metrics=None, **kw):
        def hook(s, m):
            seen.append({k: float(v) for k, v in m.items()})
            on_metrics(s, m)
        return real(*a, on_metrics=hook, **kw)
    monkeypatch.setattr(module, "run_training", spy)
    return seen


@pytest.mark.parametrize("extra", [
    [], ["--microbatches", "2"], ["--arch", "mamba2-1.3b"],
    ["--arch", "deepseek-v2-lite-16b", "--steps", "8", "--log-every", "2"]],
    ids=["granite", "microbatches", "mamba2", "deepseek"])
def test_launcher_prints_what_the_reference_prints(extra, monkeypatch,
                                                   capsys):
    argv = BASE + extra
    arch = argv[len(argv) - 1 - argv[::-1].index("--arch") + 1]
    want_seen = _logged(jtrain, argv, monkeypatch)
    jtrain.main(argv)
    want = capsys.readouterr().out
    _reference_state(monkeypatch, arch)
    got_seen = _logged(train, argv, monkeypatch)
    train.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    (gl, gn), (wl, wn) = _split(got), _split(want)
    assert gl == wl and gl[0].startswith(f"arch={arch} params=")
    assert gn.keys() == wn.keys() and gn
    for name in gn:
        np.testing.assert_allclose(gn[name], wn[name], rtol=REL, atol=1e-4,
                                   err_msg=name)
    assert len(got_seen) == len(want_seen)
    for g, w in zip(got_seen, want_seen):
        for k in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=REL, atol=REL,
                                       err_msg=k)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-2b"])
def test_front_ends_are_refused_as_the_reference_refuses(arch):
    argv = ["--arch", arch, "--smoke", "--steps", "1"]
    with pytest.raises(SystemExit) as want:
        jtrain.main(argv)
    with pytest.raises(SystemExit) as got:
        train.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)


def test_without_device_it_asks_for_the_card():
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train.main(["--arch", "granite-8b", "--smoke", "--steps", "1"])


def test_flags_are_the_references_and_device():
    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}

    ours, theirs = flags(train.build_parser()), flags(jtrain.build_parser())
    assert ours - theirs == {"--device"} and theirs <= ours


@pytest.mark.parametrize("compress", [False, True])
def test_preempt_then_resume_equals_an_uninterrupted_run(tmp_path, compress,
                                                         capsys):
    argv = ["--arch", "granite-8b", "--smoke", "--steps", "12",
            "--batch", "4", "--seq", "16", "--log-every", "3",
            "--device", "cpu"] + (["--compress-grads"] if compress else [])
    whole = str(tmp_path / "whole")
    cut = str(tmp_path / "cut")
    train.main(argv + ["--ckpt-dir", whole, "--ckpt-every", "3"])
    with pytest.raises(SimulatedPreemption):
        train.main(argv + ["--ckpt-dir", cut, "--ckpt-every", "3",
                           "--preempt-at", "7"])
    assert ckpt.all_steps(cut) == [3, 6]
    state, _ = train.main(argv + ["--ckpt-dir", cut, "--ckpt-every", "3"])
    out = capsys.readouterr().out
    assert "step     9 " in out and "done: 12 steps" in out
    a, _ = ckpt.restore(whole, state)
    b, step = ckpt.restore(cut, state)
    assert step == 12
    for (k, x), (_, y) in zip(ckpt.leaves(a), ckpt.leaves(b)):
        assert torch.equal(x, y), k
    if compress:
        assert b.ef_state is not None


def test_quickstart_presets_are_the_references():
    ours = runpy.run_path(str(ROOT / "examples" / "torch_quickstart.py"),
                          run_name="q")["PRESETS"]
    theirs = runpy.run_path(str(ROOT / "examples" / "quickstart.py"),
                            run_name="r")["PRESETS"]
    assert ours == theirs
    cfg = configs.get_config("granite-8b")
    import dataclasses
    for name, preset in ours.items():
        assert T.count_params(dataclasses.replace(cfg, **preset)) == \
            dataclasses.replace(jconfigs.get_config("granite-8b"),
                                **preset).param_count()


@pytest.mark.gpu
def test_launcher_and_quickstart_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch sees no CUDA device)")
    import os
    import subprocess
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--arch", "mamba2-1.3b", "--smoke", "--steps", "6",
                        "--log-every", "1"], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr
    losses = [float(v) for v in re.findall(r" loss=([\d.]+)", p.stdout)]
    assert len(losses) == 6 and all(np.isfinite(losses))
    q = subprocess.run([sys.executable, str(ROOT / "examples" /
                                            "torch_quickstart.py"),
                        "--steps", "60"], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert q.returncode == 0, q.stderr
