"""``chip_smoke.py``'s train phase on the CPU, at the smoke configs:
every gate of the card's run holds (a failing gate raises), with the
launcher, the preempt-and-resume and the quickstart twin run as
subprocesses on ``--device cpu``; no kernel launches, and one record a
step, in order. The profiled step is the card's only."""

import importlib.util
import json
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

#: the train phase at a CPU size: smoke configs, the launcher at --smoke,
#: the 10m quickstart for a few steps; f32 vs f64 at one SSD chunk (the
#: smoke mamba2's chunk is 16), as the card's 64 tokens are one chunk
CPU_TRAIN_SIZE = dict(
    granite_layers=2, steps=20, batch=4, seq=32, lr=1e-3,
    launcher=["--arch", "mamba2-1.3b", "--smoke", "--steps", "4",
              "--log-every", "1", "--batch", "4", "--seq", "32"],
    determinism_arch="mamba2-1.3b", determinism_steps=3, f64_layers=2,
    f64_batch=2, f64_seq=16,
    resume=["--arch", "granite-8b", "--smoke", "--steps", "12",
            "--ckpt-every", "3", "--log-every", "3", "--batch", "4",
            "--seq", "16"],
    preempt_at=7,
    quickstart=["--preset", "10m", "--steps", "60", "--seq", "64"],
    timeout_s=300)


def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_phase_passes_its_gates_on_the_cpu(capsys):
    from repro_torch import configs
    from repro_torch.kernels import KERNELS

    launches = smoke().train_phase(torch, torch.device("cpu"), "cpu",
                                   size=CPU_TRAIN_SIZE,
                                   get_config=configs.get_smoke_config)
    assert set(launches) == set(KERNELS) and not any(launches.values())
    records = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith('{"phase": "train"')]
    steps = [(r["step"], r.get("arch")) for r in records]
    assert steps == [
        ("init", "granite-8b"), ("granite", "granite-8b"),
        ("launcher", "mamba2-1.3b"), ("determinism", "mamba2-1.3b"),
        ("f32_vs_f64", "granite-8b"), ("f32_vs_f64", "deepseek-v2-lite-16b"),
        ("f32_vs_f64", "mamba2-1.3b"), ("resume", None),
        ("quickstart", None), ("flash_under_grad", None), ("launches", None)]
    by = {r["step"]: r for r in records}
    assert len(by["granite"]["losses"]) == 20
    assert by["launcher"]["params"] > 0 and len(by["launcher"]["steps"]) == 4
    assert by["determinism"]["leaves_differing"] == 0
    assert by["resume"]["steps_before_resume"] == [3, 6]
    assert by["resume"]["exit_codes"][1] != 0
    f64 = [r for r in records if r["step"] == "f32_vs_f64"]
    assert f64[1]["aux_f64"] > 0 and all(r["loss_rel"] < 1e-5 for r in f64)
