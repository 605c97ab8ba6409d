"""``chip_smoke.py``'s tooling phase on the CPU, at smoke sizes: every
gate of the card's run holds (a failing gate raises).

* ``sharded_compute``: smoke granite-8b as ``DTensor`` parameters on a
  1-device mesh (a world-1 gloo group), their local tensors the weights
  themselves; the prefill bit for bit the unsharded one, one train step
  of its first layer equal to the unsharded step; no kernel launch, the
  group gone after.
* ``tooling_phase``: the dry-run of granite's decode cell on the tiny
  mesh at smoke widths, the autotune example on the CPU (its plain
  version), and the four documents into a temporary root, with
  ``--check`` passing and nothing under ``experiments/`` or ``docs/``
  changed.
"""

import importlib.util
import json
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.kernels import KERNELS
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]


def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _records(out: str, phase: str) -> list[dict]:
    return [json.loads(ln) for ln in out.splitlines()
            if ln.startswith(f'{{"phase": "{phase}"')]


def test_sharded_compute_passes_its_gates_on_the_cpu(capsys):
    mod = smoke()
    dev = torch.device("cpu")
    cfg = configs.get_smoke_config("granite-8b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), dev)
    launches = mod.sharded_compute(
        torch, dev, cfg, params, "cpu",
        dict(prefill=(2, 16), train_layers=1, train=(2, 8), lr=1e-3))
    assert set(launches) == set(KERNELS) and not any(launches.values())
    assert not torch.distributed.is_initialized()
    recs = _records(capsys.readouterr().out, "tooling")
    assert [r["step"] for r in recs] == [
        "mesh", "prefill_on_mesh", "train_step_on_mesh", "mesh_launches"]
    assert recs[0]["backend"] == "gloo" and recs[0]["same_storage"]
    assert recs[0]["sharded_leaves"] > 0
    assert recs[1]["logits_bit_equal"] and recs[1]["cache_bit_equal"]
    step = recs[2]
    assert step["loss_bit_equal"] and step["grads"] == len(
        [n for n, _ in params.named_parameters()
         if not n.startswith("blocks.") or n.startswith("blocks.0.")])
    assert recs[-1]["group_destroyed"]


def test_tooling_phase_passes_its_gates_on_the_cpu(tmp_path, capsys):
    mod = smoke()
    widths = {k: v for k, v in vars(configs.get_smoke_config(
        "granite-8b")).items() if k in ("num_layers", "d_model", "d_ff",
                                         "vocab_size", "num_heads",
                                         "num_kv_heads", "head_dim")}
    size = dict(mod.TOOLING_SIZE, mesh="tiny", cells=("decode_32k",),
                cfg_overrides=widths, dryrun_out=str(tmp_path / "dryrun"),
                docs_root=str(tmp_path / "docs"))
    launches = mod.tooling_phase(torch, torch.device("cpu"), "cpu", size)
    assert set(launches) == set(KERNELS) and not any(launches.values())
    assert not torch.distributed.is_initialized()
    recs = _records(capsys.readouterr().out, "tooling")
    assert [r["step"] for r in recs] == [
        "torch_pieces", "dryrun", "dryrun_memory", "autotune_example",
        "docs", "launches"]
    dr = recs[1]
    assert dr["chips"] == 4 and dr["fits_16gb"] and dr["trace_s"] > 0
    assert dr["per_chip_argument_gib"] > 0 and dr["priced_for"] == "tpu_v5e"
    assert "all-gather" in dr["collectives"]
    assert (tmp_path / "dryrun" / "tiny" / "granite-8b__decode_32k.json"
            ).exists()
    assert recs[3]["max_abs_err"] < recs[3]["tol"] == 1e-4
    assert recs[4]["pages"] == ["cli.md", "experiments.md", "profiles.md",
                                "serving.md"]
