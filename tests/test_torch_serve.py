"""The port's dense ServeEngine and launcher against the JAX reference.

Both engines serve the same seeded workload (the launchers' ``_workload``)
with the same weights, carried across by ``params_from_jax``. Greedy
tokens must be identical per uid, and the engines' books (``stats()``)
equal, with ``attention_impl`` "ref" and "flash". The launcher's paged
engine must print the reference's page-length rationale and tokens.
"""

import argparse
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax
from repro_torch.core.costmodel import kv_bytes_per_token
from repro_torch.serve.engine import Request, ServeEngine

ARGS = argparse.Namespace(seed=0, requests=4, max_len=48, slots=2,
                          engine="dense")


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfigs.get_smoke_config("granite-8b")
    jparams = JT.init_params(jcfg, jax.random.key(0))
    cfg = configs.get_smoke_config("granite-8b")
    return jcfg, jparams, cfg, params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg)


def _serve(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return {r.uid: r.generated for r in engine.run_to_completion()}


@pytest.mark.parametrize("impl", ["ref", "flash"])
def test_tokens_and_stats_match_jax_engine(setup, impl):
    jcfg, jparams, cfg, params = setup
    jcfg = dataclasses.replace(jcfg, attention_impl=impl)
    cfg = dataclasses.replace(cfg, attention_impl=impl)
    jeng = JServeEngine(jcfg, jparams, max_slots=ARGS.slots,
                        max_len=ARGS.max_len)
    eng = ServeEngine(cfg, params, max_slots=ARGS.slots, max_len=ARGS.max_len)
    jreqs = jserve._workload(jcfg, ARGS)
    reqs = serve._workload(cfg, ARGS)
    for jr, r in zip(jreqs, reqs):
        np.testing.assert_array_equal(jr.prompt, r.prompt)
        assert jr.max_new_tokens == r.max_new_tokens
    want = _serve(jeng, jreqs)
    got = _serve(eng, reqs)
    assert got == want
    assert eng.stats() == jeng.stats()
    assert eng.hbm_reserved_bytes() == jeng.hbm_reserved_bytes()


def test_slots_recycled_and_oversized_request_raises(setup):
    _, _, cfg, params = setup
    eng = ServeEngine(cfg, params, max_slots=1, max_len=24)
    rng = np.random.default_rng(1)
    for uid in range(3):
        eng.submit(Request(uid, rng.integers(cfg.vocab_size, size=5)
                           .astype(np.int32), 3))
    finished = eng.run_to_completion()
    assert [r.uid for r in finished] == [0, 1, 2]
    assert all(r.slot == 0 and len(r.generated) == 3 for r in finished)
    assert list(eng.free) == [0] and not eng.active
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(9, np.zeros(20, np.int32), 5))


def test_kv_bytes_per_token_matches_cost_model():
    from repro.core.costmodel import kv_bytes_per_token as jkv
    for arch in configs.list_archs():
        for get in ("get_config", "get_smoke_config"):
            assert (kv_bytes_per_token(getattr(configs, get)(arch))
                    == jkv(getattr(jconfigs, get)(arch)))


@pytest.mark.parametrize("engine", ["dense", "loop"])
def test_launcher_runs_on_cpu_without_launches(engine, capsys):
    before = fa.launches
    out = serve.main(["--arch", "granite-8b", "--smoke", "--engine", engine,
                      "--device", "cpu", "--requests", "3", "--max-len", "32",
                      "--prompt-len", "8", "--gen", "4"])
    assert fa.launches == before
    text = capsys.readouterr().out
    if engine == "dense":
        assert len(out["finished"]) == 3 and "requests=3" in text
    else:
        assert out["tokens"].shape == (4, 4) and "prefill:" in text


@pytest.mark.parametrize("flag", [["--engine", "fleet"], ["--plan"],
                                  ["--mesh-shape", "4"]],
                         ids=["flag1", "flag2", "flag3"])
def test_unported_launcher_paths_exit_naming_roadmap(flag):
    with pytest.raises(SystemExit, match="ROADMAP"):
        serve.main(["--arch", "granite-8b", "--smoke", "--device", "cpu",
                    *flag])


def test_default_device_fails_loudly_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serve.main(["--arch", "granite-8b", "--smoke"])


@pytest.mark.parametrize("flags", [[], ["--page-len", "4", "--num-pages", "9",
                                        "--prefill-chunk", "8"]],
                         ids=["derived", "given"])
def test_paged_launcher_matches_reference_on_cpu(setup, flags, capsys):
    """``--engine paged --device cpu``: the page-length rationale and the
    books of the JAX launcher, and no flash launch. (The launchers make
    their own random weights, so the tokens differ; tests/
    test_torch_paged.py holds them to the reference on shared weights.)"""
    jcfg, jparams, _, _ = setup
    argv = ["--arch", "granite-8b", "--smoke", "--engine", "paged",
            "--requests", "5", "--max-len", "48", "--slots", "3", *flags]
    before = fa.launches
    out = serve.main([*argv, "--device", "cpu"])
    assert fa.launches == before
    ours = capsys.readouterr().out
    jargs = jserve.build_parser().parse_args(argv)
    jserve._engine_run(jcfg, jparams, jargs)
    theirs = capsys.readouterr().out

    def books(text):      # all but the wall clock and the tokens
        return [ln.replace(" device=cpu", "") for ln in text.splitlines()
                if "ms (" not in ln and "sample tokens" not in ln]

    assert books(ours) == books(theirs)
    if flags:
        assert "page_len=4 (given)" in ours and "preemptions=0" not in ours
    else:
        assert "cost-model derived" in ours and "<-- chosen" in ours
    eng = out["engine"]
    assert len(out["finished"]) == 5 and eng.alloc.allocated_pages == 0


@pytest.mark.parametrize("name", ["TeslaV100", "GTX980"])
def test_launcher_refuses_a_gpu_profile(name):
    with pytest.raises(SystemExit, match="tpu-family"):
        serve.main(["--arch", "granite-8b", "--smoke", "--device", "cpu",
                    "--profile", name])
