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
    assert all(r["summary"]["PASS"] == 9 for r in rec["runs"])
    assert rec["batched_engine_speedup"]["cmp"] == "info"
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
