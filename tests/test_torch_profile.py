"""The port's copies of the device registry, the profile store, the cost
model and the page-length pricing against the JAX package's.

The registry fingerprint must equal the reference's bit for bit, or every
committed ``experiments/profiles/*.json`` would read as stale in the
port. ``install_profile`` must refuse what the reference refuses, with
its message. ``page_len_rationale`` and ``choose_page_len`` must agree
term by term for the four ported archs, with no profile installed and
with ``tpu_v5e``.
"""

import dataclasses
import json
from pathlib import Path

import pytest

from repro import configs as jconfigs
from repro.core import costmodel as jcost
from repro.core import profile as jprofile
from repro.profile import store as jstore
from repro.serve import paging as jpaging
from repro_torch import configs
from repro_torch.core import costmodel, profile
from repro_torch.launch import serve
from repro_torch.profile import store
from repro_torch.serve import paging

ROOT = Path(__file__).resolve().parents[1]
PROFILES = sorted((ROOT / "experiments" / "profiles").glob("*.json"))
ARCHS = ("granite-8b", "minitron-8b", "deepseek-coder-33b",
         "mistral-large-123b")


def test_registry_fingerprint_matches_reference():
    assert profile.registry_fingerprint() == jprofile.registry_fingerprint()
    assert (profile.ENGINE_VERSION, profile.JAX_ENGINE_VERSION) == (
        jprofile.ENGINE_VERSION, jprofile.JAX_ENGINE_VERSION)


def test_default_root_is_the_repos_own():
    assert Path(store.DEFAULT_ROOT) == ROOT / "experiments" / "profiles"
    assert Path(store.path_for("tpu_v5e")) == ROOT / "experiments" / \
        "profiles" / "tpu_v5e.json"


@pytest.mark.parametrize("path", PROFILES, ids=lambda p: p.stem)
def test_committed_profiles_load_fresh(path):
    prof = store.load_profile(path.stem)
    assert prof.is_stale() == []
    assert prof.to_json() == jstore.load_profile(str(path)).to_json()
    if prof.kind == "tpu":
        assert dataclasses.asdict(prof.tpu_spec()) == dataclasses.asdict(
            jstore.load_profile(str(path)).tpu_spec())


def _exit_message(install, arg) -> str:
    with pytest.raises(SystemExit) as e:
        install(arg)
    return str(e.value)


def test_install_profile_refuses_a_gpu_profile_as_the_reference_does():
    ours = _exit_message(store.install_profile, "TeslaV100")
    theirs = _exit_message(jstore.install_profile,
                           str(ROOT / "experiments/profiles/TeslaV100.json"))
    # the two name the artifact they were given and their own root
    ours = ours.replace("TeslaV100", "X", 1).replace(
        store.path_for("tpu_v5e"), "ROOT")
    theirs = theirs.replace(str(ROOT / "experiments/profiles/TeslaV100.json"),
                            "X", 1).replace(jstore.path_for("tpu_v5e"), "ROOT")
    assert ours == theirs and "tpu-family" in ours
    assert profile.get_default_profile() is None


def test_install_profile_refuses_a_stale_profile_as_the_reference_does(
        tmp_path):
    raw = json.loads((ROOT / "experiments/profiles/tpu_v5e.json").read_text())
    raw["registry_hash"] = "0" * 16
    stale = tmp_path / "tpu_v5e.json"
    stale.write_text(json.dumps(raw))
    ours = _exit_message(store.install_profile, str(stale))
    assert ours == _exit_message(jstore.install_profile, str(stale))
    assert "stale" in ours and profile.get_default_profile() is None


def test_install_profile_installs_tpu_v5e():
    prev = profile.get_default_profile()
    try:
        prof = store.install_profile("tpu_v5e")
        assert profile.get_default_profile() is prof
        assert profile.resolve_spec() == prof.tpu_spec()
    finally:
        profile.set_default_profile(prev)
    assert profile.resolve_spec() == profile.TPU_V5E


@pytest.mark.parametrize("installed", [None, "tpu_v5e"])
@pytest.mark.parametrize("max_len", [48, 96, 768, 2048])
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_page_len_pricing_matches_reference(arch, smoke, max_len, installed):
    get = "get_smoke_config" if smoke else "get_config"
    cfg, jcfg = getattr(configs, get)(arch), getattr(jconfigs, get)(arch)
    ours = theirs = None
    if installed:
        ours = store.load_profile(installed)
        theirs = jstore.load_profile(installed,
                                     str(ROOT / "experiments" / "profiles"))
    with profile.use_profile(ours), jprofile.use_profile(theirs):
        terms = paging.page_len_rationale(cfg, expected_tokens=max_len)
        jterms = jpaging.page_len_rationale(jcfg, expected_tokens=max_len)
        assert ([dataclasses.asdict(t) for t in terms]
                == [dataclasses.asdict(t) for t in jterms])
        assert (paging.choose_page_len(cfg, expected_tokens=max_len)
                == jpaging.choose_page_len(jcfg, expected_tokens=max_len))
    assert profile.get_default_profile() is None


def test_granite_pages_on_the_card_are_sized_from_tpu_v5e():
    """With no profile installed the pricing resolves to the published
    TPU v5e: 128 tokens at max_len 768 and 256 at 2048."""
    cfg = configs.get_config("granite-8b")
    assert paging.choose_page_len(cfg, expected_tokens=768) == 128
    assert paging.choose_page_len(cfg, expected_tokens=2048) == 256
    assert costmodel.kv_bytes_per_token(cfg) == 147_456


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_costs_match_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    plan, jplan = costmodel.ParallelismPlan(1, 1), jcost.ParallelismPlan(1, 1)
    for fn in ("prefill_cell_cost", "decode_cell_cost", "train_cell_cost"):
        ours = getattr(costmodel, fn)(cfg, global_batch=4, seq=768,
                                      plan=plan, name=arch)
        theirs = getattr(jcost, fn)(jcfg, global_batch=4, seq=768,
                                    plan=jplan, name=arch)
        assert ours.to_json() == theirs.to_json()
    assert cfg.param_count() == jcfg.param_count()


def test_launcher_profile_installs_through_the_store(capsys):
    prev = profile.get_default_profile()
    try:
        out = serve.main(["--arch", "granite-8b", "--smoke", "--device",
                          "cpu", "--engine", "paged", "--profile", "tpu_v5e",
                          "--requests", "2", "--max-len", "24"])
        assert profile.get_default_profile().device == "tpu_v5e"
    finally:
        profile.set_default_profile(prev)
    assert "profile: tpu_v5e" in capsys.readouterr().out
    assert len(out["finished"]) == 2
