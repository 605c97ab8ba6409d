"""The host-side arithmetic of ``chip_smoke.py``, which reads the card's
torch.profiler traces and sizes the strided probe's conflicts: checked on
synthetic traces and addresses, without a card."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def smoke():
    """``chip_smoke.py`` as a module (its top level imports the standard
    library only)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kernel(name, corr, ts, dur):
    return {"cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _launch(name, corr):
    return {"cat": "cuda_runtime", "name": name, "ts": corr,
            "args": {"correlation": corr}}


@pytest.mark.parametrize("dropped,want", [
    ((), []),
    ((1, 2, 6, 7), []),
    ((4,), [("cudaMemcpyAsync", 1)]),
    ((1, 3, 5), [("cudaLaunchKernel", 2), ("cuLaunchKernelEx", 0)])])
def test_window_finds_the_calls_whose_device_event_is_missing(dropped, want):
    """Calls 1-2 and 6-7 are the settling spins around the window's three
    device calls; a spin's lost event is no loss, and no spin is kept."""
    names = {3: "cudaLaunchKernel", 4: "cudaMemcpyAsync",
             5: "cuLaunchKernelEx"}
    events = [_launch(names.get(c, "cudaLaunchKernel"), c)
              for c in range(1, 8)] + [_launch("cudaStreamSynchronize", 8)]
    events += [{"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 0, "dur": 1,
                "args": {"correlation": 4}}] if 4 not in dropped else []
    events += [_kernel("spin" if c in (1, 2, 6, 7) else "k", c, 0, 1)
               for c in (1, 2, 3, 5, 6, 7) if c not in dropped]
    dev, missing = smoke().window(events, settling=2)
    assert [(m["call"], m["calls_after"]) for m in missing] == want
    assert sorted(e["args"]["correlation"] for e in dev) == [
        c for c in (3, 4, 5) if c not in dropped]


def test_window_without_launch_calls_keeps_every_device_event():
    dev, missing = smoke().window([_kernel("k", 1, 0, 1)], settling=2)
    assert missing is None and len(dev) == 1


def test_busy_from_trace_unions_overlapping_spans():
    events = [_kernel("flash_wgmma<1, 128>", 1, 0, 10),
              _kernel("gemm", 2, 5, 10), _kernel("gemm", 3, 30, 5)]
    got = smoke().busy_from_trace(events, wall_ms=0.1)
    assert got["device_busy_ms"] == pytest.approx(0.020)
    assert got["idle_share"] == pytest.approx(0.8)
    assert got["flash_ms"] == pytest.approx(0.010)
    assert got["top_kernels_ms"][0] == ["gemm", pytest.approx(0.015)]


class _FakeTorch:
    """What the trace helpers ask of torch: a synchronise."""
    class cuda:
        @staticmethod
        def synchronize():
            pass


def _blind_or_not(mod, kernels, monkeypatch):
    """Patch ``mod`` so that each trace holds the settling spins' and the
    window's launches, with device events only for ``kernels`` (a name
    each, correlated with the window's first launches), and every event
    mean reads 1.25 ms."""
    spins = mod.SETTLING_CALLS

    def traced(torch, fn, path):
        fn()
        n = 2 * spins + 20
        events = [_launch("cudaLaunchKernel", c) for c in range(1, n + 1)]
        return events + [_kernel(k, spins + 1 + i, i, 3)
                         for i, k in enumerate(kernels)]

    monkeypatch.setattr(mod, "traced", traced)
    monkeypatch.setattr(mod, "time_ms", lambda torch, fn, iters, warmup=3:
                        1.25)


def test_device_ms_times_with_events_where_the_profiler_is_blind(
        monkeypatch, capsys):
    """Every attempt's launches without a device event: the event mean
    stands in, flagged, and a warning names the kernel."""
    mod = smoke()
    _blind_or_not(mod, [], monkeypatch)
    ms, info = mod.device_ms(_FakeTorch, lambda: None, 20, "flash_wgmma")
    assert ms == 1.25
    assert info["blind"] and info["source"] == "cuda_events"
    assert info["attempts"] == mod.TRACE_ATTEMPTS and not info["complete"]
    assert "flash_wgmma" in capsys.readouterr().err


def test_device_ms_still_fails_where_the_trace_misses_only_the_kernel(
        monkeypatch):
    """A trace that holds device events, none of them the named kernel's,
    is not blind: it fails as before."""
    mod = smoke()
    _blind_or_not(mod, ["other"] * 20, monkeypatch)
    with pytest.raises(RuntimeError, match="no device event"):
        mod.device_ms(_FakeTorch, lambda: None, 20, "flash_wgmma")


def test_copy_turns_take_the_event_turns_where_the_profiler_is_blind(
        monkeypatch):
    mod = smoke()
    _blind_or_not(mod, [], monkeypatch)
    got = mod.copy_times_in_turns(_FakeTorch, lambda: None, lambda: None,
                                  "memcpy_kernel", rounds=5, calls=10)
    assert got["device_trace"]["source"] == "cuda_events"
    assert got["device_ms"] == got["ms"] == 1.25
    assert got["turns"]["device_ms"] == got["turns"]["event_ms"]


@pytest.mark.parametrize("n,w,stride,ways", [
    (1024, 32, 1, 1), (1024, 32, 2, 2), (1024, 32, 8, 8), (1024, 32, 32, 32),
    (1024, 32, 33, 1), (1024, 32, 64, 16), (1024, 32, 128, 8),
    (128, 256, 1, 1), (128, 256, 32, 4)])
def test_conflict_degree_of_the_probe(n, w, stride, ways):
    """Rows of w + 1 words: a warp's lanes on 32 distinct rows of stride s
    meet gcd(s, 32) to a bank while 32 rows stay distinct; at 128 rows
    they repeat, and 4 is the most."""
    assert smoke().conflict_degree(n, w, stride) == ways


def test_device_turns_split_the_kernel_from_its_library_call_in_order():
    """A trace of kernel, copy_, copy_, kernel: each call's device ms in
    the order the calls ran, whatever order the trace lists them in."""
    k = "(anonymous namespace)::memcpy_kernel(const unsigned char*, ...)"
    lib = "Memcpy DtoD (Device -> Device)"
    dev = [_kernel(k, 4, 40, 740), _kernel(lib, 2, 10, 710),
           _kernel(k, 1, 0, 750), _kernel(lib, 3, 20, 720)]
    assert smoke().device_turns(dev, "memcpy_kernel") == {
        "kernel": [0.75, 0.74], "library": [0.71, 0.72]}


#: the fleet phase at a CPU size: the same steps and gates as on the card
CPU_FLEET_SIZE = dict(requests=6, slots=2, max_len=48, trace_rate=0.5,
                      trace_horizon=12, campaign_requests=6,
                      campaign_rate=0.2, f32_layers=2, f32_requests=4,
                      f32_slots=2)


def test_fleet_phase_passes_its_gates_on_the_cpu(capsys):
    """``fleet_phase`` on smoke granite-8b, on the CPU: every gate of the
    card's run holds (a failing gate raises), no kernel launches, and one
    record a step."""
    import argparse
    import json

    import torch

    from repro_torch import configs
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    mod = smoke()
    dev = torch.device("cpu")
    cfg = configs.get_smoke_config("granite-8b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), dev)
    args = argparse.Namespace(requests=4, slots=2, max_len=48, seed=0,
                              engine="paged", page_len=None, num_pages=None,
                              prefill_chunk=None)
    eng = serve._paged_engine(cfg, params, args)
    res = serve._engine_run(cfg, params, args, engine=eng)
    paged = dict(requests=4, slots=2, max_len=48, seed=0,
                 tokens={r.uid: r.generated for r in res["finished"]},
                 ticks=eng.steps, page_len=eng.page_len,
                 num_pages=eng.alloc.num_pages)
    capsys.readouterr()
    launches = mod.fleet_phase(torch, dev, cfg, params, paged, "cpu",
                               size=CPU_FLEET_SIZE)
    assert set(launches) == set(KERNELS)
    assert not any(launches.values())
    records = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith('{"phase": "fleet"')]
    assert [r["step"] for r in records] == [
        "n1_oracle", "dissect_on_start", "heterogeneous", "tiers_auto",
        "fault_campaign", "mixed_vs_n1_f32", "launches"]
    het = records[2]
    assert het["requests"] == 6 and het["pages_leaked"] == 0
    assert [r["name"].split(":")[1] for r in het["replicas"]] == [
        "tpu_v5e", "TeslaV100", "GTX980"]
    assert records[3]["handoffs"] > 0


def test_parallel_phase_passes_its_gates_on_the_cpu(capsys):
    """``parallel_phase`` on smoke granite-8b, on the CPU (a world-1 gloo
    group): every gate of the card's run holds (a failing gate raises),
    no kernel launches, one record a step, and the group gone after."""
    import argparse
    import json

    import torch

    from repro_torch import configs
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    mod = smoke()
    dev = torch.device("cpu")
    cfg = configs.get_smoke_config("granite-8b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), dev)
    args = argparse.Namespace(requests=4, slots=2, max_len=48, seed=0,
                              engine="paged", page_len=None, num_pages=None,
                              prefill_chunk=None)
    eng = serve._paged_engine(cfg, params, args)
    res = serve._engine_run(cfg, params, args, engine=eng)
    paged = dict(requests=4, slots=2, max_len=48, seed=0,
                 tokens={r.uid: r.generated for r in res["finished"]},
                 ticks=eng.steps, page_len=eng.page_len,
                 num_pages=eng.alloc.num_pages, tokens_per_s=1.0)
    capsys.readouterr()
    path, phase = mod.parallel_phase(torch, dev, cfg, params, paged, "cpu")
    for launches in (path, phase):
        assert set(launches) == set(KERNELS) and not any(launches.values())
    assert not torch.distributed.is_initialized()
    records = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith('{"phase": "parallel"')]
    assert [r["step"] for r in records] == [
        "mesh", "mesh1_serve", "launcher_fleet", "restore_onto_mesh",
        "pipeline", "launches"]
    assert records[0]["backend"] == "gloo" and records[0]["world"] == 1
    serve1 = records[1]
    assert serve1["gather_shards"] == 1 and serve1["pages_leaked"] == 0
    assert serve1["pool_placements"] == {"k": ["S(3)"], "v": ["S(3)"]}
    assert records[3]["dtensor_leaves"] == 3 * len(list(
        T.init_params(cfg, None, "meta").parameters()))
    assert records[-1]["group_destroyed"]


#: the families phase at a CPU size, on the smoke configs
CPU_FAMILIES_SIZE = dict(requests=4, slots=2, max_len=48, loop_batch=2,
                         loop_prompt=16, loop_gen=4, f32_layers=2,
                         f32_requests=3, audio_batch=1, audio_frames=32,
                         prefill_batch=2, prefill_tokens=16, phi_layers=2,
                         phi_f32_layers=1, smoke_requests=4, smoke_slots=2,
                         smoke_max_len=48)


def test_families_phase_passes_its_gates_on_the_cpu(capsys):
    """``families_phase`` on the smoke configs, on the CPU: every gate of
    the card's run but the launch counts holds (a failing gate raises),
    no kernel launches on the main path or over the phase, and one record
    a step, in order."""
    import json

    import torch

    from repro_torch import configs
    from repro_torch.kernels import KERNELS

    path, phase = smoke().families_phase(
        torch, torch.device("cpu"), "cpu", size=CPU_FAMILIES_SIZE,
        get_config=configs.get_smoke_config)
    for launches in (path, phase):
        assert set(launches) == set(KERNELS) and not any(launches.values())
    records = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith('{"phase": "families"')]
    steps = [(r["step"], r.get("arch")) for r in records]
    ds, mb = "deepseek-v2-lite-16b", "mamba2-1.3b"
    assert steps == [
        ("init", ds), ("loop", ds), ("loop", ds),
        ("mla_absorbed_vs_naive", ds), ("dense", ds), ("paged", ds),
        ("paged_vs_dense_f32", ds), ("init", mb), ("loop", mb),
        ("dense", mb), ("paged", mb), ("paged_vs_dense_f32", mb),
        ("flash_path", "hubert-xlarge"), ("flash_path", "internvl2-2b"),
        ("flash_path", "phi3.5-moe-42b-a6.6b"),
        ("smoke_paged_vs_dense", "jamba-1.5-large-398b"),
        ("smoke_paged_vs_dense", "phi3.5-moe-42b-a6.6b"), ("launches", None)]
    paths = {r["arch"]: r for r in records if r["step"] == "flash_path"}
    assert paths["hubert-xlarge"]["causal"] is False
    assert paths["hubert-xlarge"]["calls_within_gates"] == 2
    assert paths["internvl2-2b"]["output_shape"] == [2, 1, 256]
    assert (records[-1]["launches"], records[-1]["phase_launches"]) == (
        path, phase)


#: the bench phase at a CPU size: two of the harness's experiments, on the
#: CPU through a spawned pool and serially
CPU_BENCH = dict(runs=(("cpu", 2), ("cpu", 1)),
                 only=("table8_bank_conflict", "profile_roundtrip"),
                 records=9)


def test_bench_phase_passes_its_gates_on_the_cpu(tmp_path, capsys):
    """``bench_phase`` on a subset, on the CPU: every gate of the card's
    run but the launch counts holds (a failing gate raises), no kernel
    launches, one record."""
    import json

    from repro_torch.kernels import KERNELS

    mod = smoke()
    launches = mod.bench_phase("cpu", out_dir=tmp_path, min_launches={},
                               **CPU_BENCH)
    assert launches == dict.fromkeys(KERNELS, 0)
    [rec] = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"phase": "bench"')]
    assert [(r["torch_device"], r["jobs"], r["records"])
            for r in rec["runs"]] == [("cpu", 2, 9), ("cpu", 1, 9)]
    # the race's 10x gate counts here as in the reference's own harness;
    # it measured about 28x on the CPU, best of 2 for each engine
    assert all(r["summary"]["PASS"] == 9 for r in rec["runs"])
    # the race runs on the CPU too (gate 10x), launching no scan
    assert rec["batched_engine_speedup"]["cmp"] == "ge"
    assert "0 scan launches on cpu" in rec["batched_engine_speedup"]["detail"]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "chip_smoke_cpu_jobs1.json", "chip_smoke_cpu_jobs1.log",
        "chip_smoke_cpu_jobs2.json", "chip_smoke_cpu_jobs2.log"]


def _artifact():
    """A two-record artifact of the harness, as ``write_artifact`` lays it
    out."""
    def metric(name, measured, **kw):
        return {"name": name, "measured": measured, "expected": kw.get(
            "expected"), "cmp": kw.get("cmp", "info"), "tol": 0.05,
            "unit": "", "detail": "", "us": kw.get("us", 0.0),
            "verdict": kw.get("verdict", "INFO")}
    rec = dict(section="§6.2", artifact="Table 8", verdict="PASS",
               elapsed_s=0.5, error=None)
    return {"summary": {"PASS": 2, "DEVIATION": 0, "INFO": 0, "ERROR": 0},
            "records": [
                {**rec, "experiment": "table8_bank_conflict",
                 "device": "GTX980", "metrics": [
                     metric("slope_cycles_per_way", 2.0, expected=2.0,
                            cmp="close", verdict="PASS", us=3.0)]},
                {**rec, "experiment": "table8_bank_conflict",
                 "device": "tpu_v5e", "metrics": [
                     metric("host_memcpy_gbps", 174.36, us=9.0),
                     metric("strided_kernel_matches_oracle", True,
                            expected=True, cmp="eq", verdict="PASS")]}]}


def _timings_differ(a):
    a["records"][0]["elapsed_s"] = 9.0
    a["records"][0]["metrics"][0]["us"] = 1.0
    a["records"][1]["metrics"][0]["measured"] = 1.0


def _measured_differs(a):
    a["records"][0]["metrics"][0]["measured"] = 2.5


def _order_differs(a):
    a["records"].reverse()


def _strided_false(a):
    a["records"][1]["metrics"][1]["measured"] = False


def _deviation(a):
    a["summary"]["DEVIATION"] = 1


@pytest.mark.parametrize("change,both,ok", [
    (None, False, True), (_timings_differ, False, True),
    (_measured_differs, False, False), (_order_differs, False, False),
    (_strided_false, True, False), (_deviation, True, False)])
def test_compare_bench_masks_only_the_timings(change, both, ok):
    """Two runs may differ in their timings alone; a gate on the first
    run (the strided check) or on both (no deviation) holds even where
    the two agree."""
    mod = smoke()
    a, b = _artifact(), _artifact()
    for art in (a, b) if both else (a,):
        if change:
            change(art)
    if ok:
        mod.compare_bench(a, b, records=2)
    else:
        with pytest.raises(RuntimeError):
            mod.compare_bench(a, b, records=2)


# -- the train phase's host-side arithmetic ------------------------------------


@pytest.mark.parametrize("losses,falls", [
    ([5.0] * 5 + [4.0] * 5, True),
    ([5.0] * 10, False),
    ([4.0] * 5 + [5.0] * 5, False),
    ([5.0] * 9, False),                   # too few for two windows of 5
    ([6, 5, 5, 5, 4, 9, 1, 1, 1, 1, 1], True)])
def test_loss_falls_compares_the_first_and_last_five(losses, falls):
    assert smoke().loss_falls(losses) is falls


def test_parse_train_log_reads_the_launchers_lines():
    text = ("arch=mamba2-1.3b params=1,450,000,000 devices=1\n"
            "step     1 loss=10.8123 ce=10.8123 gnorm=3.125 tok/s=1,024 "
            "stragglers=0\n"
            "step     2 loss=nan ce=nan gnorm=inf tok/s=3,072 stragglers=1\n"
            "done: 2 steps in 1.5s (1,365 tok/s) final_loss=nan\n")
    log = smoke().parse_train_log(text)
    assert (log["arch"], log["params"], log["done"]) == (
        "mamba2-1.3b", 1_450_000_000, True)
    assert [r["step"] for r in log["steps"]] == [1, 2]
    assert log["steps"][0] == {"step": 1, "loss": 10.8123, "ce": 10.8123,
                               "gnorm": 3.125, "tok_s": 1024,
                               "stragglers": 0}
    assert not smoke().finite([r["loss"] for r in log["steps"]])
    assert smoke().finite([r["loss"] for r in log["steps"][:1]])
    assert not smoke().finite([])
    cut = smoke().parse_train_log(text.rsplit("done", 1)[0])
    assert not cut["done"] and len(cut["steps"]) == 2
    assert smoke().parse_train_log("Traceback ...\n") == {
        "arch": None, "params": None, "steps": [], "done": False}


def test_parse_quickstart_log_reads_the_rates_and_the_ce():
    text = ("preset=100m: 109.6M params, 200 steps × 8×256 tokens\n"
            "  step   20  ce=8.1234  (51,200 tok/s)\n"
            "  step   40  ce=6.0000  (49,000 tok/s)\n"
            "done in 12s: ce 9.011 -> 1.234 (uniform would be 9.011)\n")
    q = smoke().parse_quickstart_log(text)
    assert q == {"steps": [20, 40], "ce": [8.1234, 6.0],
                 "tok_s": [51200, 49000], "first_last_ce": [9.011, 1.234]}
    assert smoke().parse_quickstart_log("")["first_last_ce"] is None


def test_train_launches_field_on_every_kernel():
    kernels = [{"name": "flash_attention"}, {"name": "rmsnorm"}]
    smoke().add_phase_launches(kernels, {
        "families_launches": {"flash_attention": 80, "rmsnorm": 0},
        "train_launches": {"flash_attention": 0, "rmsnorm": 0}})
    assert kernels == [
        {"name": "flash_attention", "families_launches": 80,
         "train_launches": 0},
        {"name": "rmsnorm", "families_launches": 0, "train_launches": 0}]
    with pytest.raises(KeyError):
        smoke().add_phase_launches([{"name": "pchase"}],
                                   {"train_launches": {}})
