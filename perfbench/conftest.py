"""The benchmark's tests: the ``gpu`` marker (tests that need an NVIDIA
card skip without one, deciding inside the test), and a tiny benchmark
tree of its own for the CPU: dense and MLA + MoE configurations at smoke
size in float32, an open and a closed chat mix and a training mix,
short enough to run in seconds."""

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card; skips with a reason without one")


TINY_DENSE = {
    "name": "tiny-dense", "source": "smoke size of granite-8b",
    "reference": "dense", "dtype": "float32", "num_hidden_layers": 2,
    "hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 256,
    "tie_word_embeddings": False, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-6,
    "port": {"name": "tiny-dense", "family": "dense", "num_layers": 2,
             "d_model": 64, "d_ff": 128, "vocab_size": 256, "num_heads": 4,
             "num_kv_heads": 2, "head_dim": 16, "rope_theta": 10000.0,
             "norm_eps": 1e-6, "dtype": "float32", "param_dtype": "float32"},
}

TINY_MOE = {
    "name": "tiny-moe", "source": "smoke size of deepseek-v2-lite",
    "reference": "mla_moe", "dtype": "float32", "num_hidden_layers": 2,
    "hidden_size": 64, "intermediate_size": 96, "num_attention_heads": 4,
    "num_key_value_heads": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
    "qk_rope_head_dim": 8, "v_head_dim": 16, "n_routed_experts": 8,
    "num_experts_per_tok": 2, "moe_intermediate_size": 48,
    "n_shared_experts": 1, "first_k_dense_replace": 0,
    "norm_topk_prob": True, "routed_scaling_factor": 1, "vocab_size": 256,
    "tie_word_embeddings": False, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-6,
    "port": {"name": "tiny-moe", "family": "moe", "num_layers": 2,
             "d_model": 64, "d_ff": 48, "vocab_size": 256, "num_heads": 4,
             "num_kv_heads": 4, "use_mla": True, "mla_absorbed": True,
             "kv_lora_rank": 32, "qk_nope_dim": 16, "qk_rope_dim": 8,
             "v_head_dim": 16, "head_dim": 16, "num_experts": 8,
             "num_shared_experts": 1, "top_k": 2, "d_ff_expert": 48,
             "capacity_factor": 4.0, "rope_theta": 10000.0,
             "norm_eps": 1e-6, "dtype": "float32", "param_dtype": "float32"},
}

LENGTHS = {"prompt": {"shape": 2.0, "mean": 20, "lo": 4, "hi": 40},
           "output": {"shape": 1.5, "mean": 6, "lo": 2, "hi": 12}}
MIXES = {
    "tiny-open": {"loop": "open", "rate_rps": 10.0, "ramp_s": 0.5,
                  "base_seed": 7, **LENGTHS},
    "tiny-closed": {"loop": "closed", "clients": 4, "ramp_s": 1.0,
                    "start_spread_s": 0.05, "base_seed": 8, **LENGTHS},
    "tiny-train": {"loop": "train", "seq_len": 32, "batch": 2,
                   "base_seed": 9},
}
ENGINE = {"max_slots": 4, "max_len": 64, "prefill_chunk": 16, "page_len": 8}
SAMPLE = {"served_tokens": 200, "max_requests": 40}
TRAIN = {"lr": 1e-3, "warmup": 0, "total_steps": 100, "microbatches": 1,
         "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
         "clip_norm": 1.0, "moment_dtype": "float32", "checked_steps": 3,
         "reference_steps": 2}
CELLS = {
    "tiny-dense.open": ("tiny-dense", "tiny-open", "serve"),
    "tiny-moe.closed": ("tiny-moe", "tiny-closed", "serve"),
    "tiny-dense.train": ("tiny-dense", "tiny-train", "train"),
}
#: float32 against float32: agreement to rounding
LIMITS = {"serve": {"gap_max": 1e-3},
          "train": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3}}


def write_tree(root: Path, here: Path) -> None:
    """A benchmark tree under ``root`` whose files lie in ``here``: the
    real manifest's metrics, the tiny configurations, mixes and cells."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for d in ("configs", "cells", "mixes"):
        (here / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(HERE / "metrics", here / "metrics", dirs_exist_ok=True)
    rel = here.relative_to(root)
    bench["configs"] = []
    for cfg in (TINY_DENSE, TINY_MOE):
        (here / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": cfg["name"], "source": cfg["source"],
                                 "file": f"{rel}/configs/{cfg['name']}.json",
                                 "reduced": [], "why": "smoke size"})
    for name, mix in MIXES.items():
        (here / "mixes" / f"{name}.json").write_text(json.dumps(mix))
    bench["workloads"] = []
    names = {"tiny-dense.open": "granite-8b.chat",
             "tiny-moe.closed": "deepseek-v2-lite.chat-closed",
             "tiny-dense.train": "granite-8b.train-4k"}
    for cell, (cfg, mix, driver) in CELLS.items():
        spec = {"name": cell, "config": cfg, "mix": mix, "driver": driver,
                "limits": LIMITS[driver]}
        if driver == "serve":
            spec.update(engine=ENGINE, sample=SAMPLE)
        else:
            spec["train"] = TRAIN
        (here / "cells" / f"{cell}.json").write_text(json.dumps(spec))
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": mix, "chips": 1, "why": "smoke"})
    # the tiny cells stand where the real ones do in the metrics' lists
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [c for c, real in names.items()
                              if real in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny models on one CPU thread: several test workers share the
    machine, and a tiny run's ticks are many small ops."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tiny(tmp_path):
    """(root, here) of a tiny benchmark tree."""
    here = tmp_path / "pb"
    write_tree(tmp_path, here)
    return tmp_path, here


@pytest.fixture
def tiny_configs():
    return copy.deepcopy({"tiny-dense": TINY_DENSE, "tiny-moe": TINY_MOE})
