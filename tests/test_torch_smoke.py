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
