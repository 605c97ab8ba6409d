#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA card and check them.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
nvidia-smi. It builds every kernel of the port from
``src/repro_torch/kernels/csrc/`` into ``build/repro_torch/``. Each phase
prints one JSON record on a line of its own; any failure raises and exits
non-zero. Phases:

  device   the card's name and power limit (nvidia-smi) and torch's name
  build    all seven kernels, one nvcc each, started together; ptxas
           registers, shared memory and spills; the HGMMA instructions in
           the bf16 flash kernels' SASS (cuobjdump), which must be there
  check    the flash kernel against its plain PyTorch version on the card,
           bf16 (the tensor-core route) and float32 (the FMA route), at
           granite-8b's heads over ragged and long lengths, small head dims
           and three GQA ratios, and at the families phase's shapes
           (D 80 non-causal, GQA 16/8 at 512); bf16 also by the worst
           relative RMS of a 64-row tile, beside the reading of one
           skipped kv tile
  times    kernel, plain version, the PyTorch library call and the bound,
           each kernel and library call also as device time per launch
           from a torch.profiler trace (the event mean of back-to-back
           calls is set by the host where the kernel is short); a trace
           that misses kernels is taken again, and flagged if it stays
           short
  check    the rmsnorm kernel against its plain version at granite-8b's
           and mistral-large's widths and a width that takes the scalar
           tail, float32 and bfloat16, and its ValueError on CUDA tensors
  times    rmsnorm beside plain, torch.nn.functional.rms_norm and bound ms
  check    the measurement kernels (pchase, memcpy, dbuf_copy, strided)
           against their plain versions on the card, exactly, at the
           paper's sizes (1 GiB copies, a 64 MB chase, the strided probe
           at every stride 1-257 of its timed shapes) and at the copies'
           edges (memcpy from an unaligned start and with a short last
           batch; dbuf_copy ending in a partial tile and a 13-byte tail at
           every depth, and from starts 1, 3 and 15 bytes past 16-byte
           alignment at every depth), and each ValueError on CUDA tensors
           (divisibility, depth)
  times    the same kernels' ms beside plain, library and bound ms; memcpy
           and dbuf_copy in turns with copy_ (kernel, copy_, copy_,
           kernel, five times), every turn recorded beside the medians,
           and the host's time to issue one call of each
  measure  the paper's measurement path end to end: P-chase cycles per
           access at L1, L2 and device-memory footprints (gated L1 < L2 <
           device memory), Wong's and Saavedra's curves through the trace
           backend with their classic readings, copy throughput, the
           dbuf_copy depth curve beside copy_ and the strided probe's
           stride curve at (128, 256) and (1024, 32) float32, device time
           beside the bank conflict degree its addresses give
  dissect  the batched cache engine's scan kernel against its plain
           version (16 lanes of every registered simulated cache, 4,096
           accesses each) and the numpy Cache (2^16 accesses a lane, the
           LRU lanes), and its ValueError for a lane too wide for shared
           memory; then the dissection path, counted: dissect_device of
           GTX560Ti, GTX780, GTX980 and TeslaV100 with the torch engine on
           the card and with the vector engine, each diffed against the
           committed experiments/profiles with no failing row, and the
           torch backend's traces that take the scan (a stride that does
           not tile, a custom index stream, run and run.batch) against the
           vector engine's; the torch engine's speedup over the vector
           engine on GTX980's structures (best of 2, trace cache off, gated
           at 10x); the kernel's times at 16 x 2^16 accesses beside its
           plain version's (at 16 x 4,096, scaled), its bytes bound and its
           latency bound (one L1 round trip an access, from P-chase stamps)
  serving  full-width granite-8b (36 layers, random bf16 weights from a
           seed) through the launcher's fixed-batch loop and its dense
           engine; every prefill must launch the flash kernel once per
           layer, on its bf16 tensor-core route, and flash prefill logits
           must match the "ref" path's in float32; then a warm prefill and
           a warm run of decode steps under torch.profiler, for the
           device's busy time beside the wall time (these phases run last:
           a torch.profiler trace taken after their large traces misses
           kernels)
  paged    the same weights and workload through the launcher's paged
           engine (pages sized by the cost model: 128 tokens), checked
           after every tick, with no leaked page, at most a page of slack
           and no flash launch (paged attention is masked, so it takes the
           plain branch); a warm window of its decode ticks under
           torch.profiler; the same workload on a pool sized from its own
           lengths so that it must preempt; and in float32 at 4 layers, the
           first decode logits of the paged engine against the dense
           engine's, gated
  fleet    the dissect→deploy loop through the port's fleet on the same
           weights, one copy shared by every replica: an N=1 fleet on the
           paged phase's workload, its tokens and ticks bit for bit the
           paged engine's; GTX980 dissected on start (torch engine, trace
           cache off) with no failing diff row, no scan launch, and the
           committed profile's page_len and pool; three replicas
           (tpu_v5e, TeslaV100, the fresh GTX980) streaming the
           launcher's fleet workload through the front end, checked every
           tick, no leaked page, no margin violation, replayed with the
           same decision log and tokens; auto tiers on a seeded chat trace
           and a seeded fault campaign, each run twice and held to
           bit-identical replay; float32 at 4 layers, a tpu_v5e/TeslaV100
           fleet's tokens equal to N=1's; no flash and no scan launch
  parallel the port's parallelism on a 1-device mesh (a world-1 NCCL
           group of this process): the paged phase's weights and
           workload served with the KV pool's leaves as DTensors on the
           mesh, tokens and ticks bit for bit the paged engine's, gather
           shards 1, no leaked page and the pool's storage unchanged on
           every tick, its tok/s beside the unsharded run's (host clock),
           and a warm window of 8 decode ticks under torch.profiler
           beside the paged phase's;
           the launcher's fleet with --mesh-shape 1 at --smoke and its
           mesh line; a smoke train state saved and restored onto the
           mesh, bit-equal, its leaves DTensors there; pipeline_apply on
           one stage against the sequential model with its gradients;
           no kernel launched by the mesh engine's run (the kernels
           line's parallel_launches, every count set to 0 just before it
           and read just after; parallel_phase_launches counts the whole
           phase); the group destroyed at the end
  bench    the paper's experiments (Tables 5-8, Figs 4/5, 8, 12, 14, 19,
           the profile round trip and the six serving experiments)
           through the port's harness CLI, twice in full mode: on the
           card with four spawned workers, then on the CPU serially, each
           under a fresh trace-cache root, artifacts under
           build/repro_torch/bench/; 36 records each, none a DEVIATION or
           an ERROR, in the same order, every metric equal between the two
           runs with only the timings masked (BENCH_TIMING_METRICS);
           strided_kernel_matches_oracle true on the card; at least 3
           memcpy and 6 strided launches; no file under experiments/ or
           docs/ changed
  families the other model families through the port's entry points:
           deepseek-v2-lite-16b (MLA + MoE, 27 layers, 16.2 B parameters)
           and mamba2-1.3b (48 SSD layers) at full width and depth in
           bf16, random weights from a seed, through the launcher's loop
           (MLA naive and absorbed), dense engine and paged engine
           (checked every tick) on the serving phase's workload, peak
           memory printed; each in float32 at 4 layers, MoE capacity
           lifted, paged tokens equal to dense and first-decode logits
           gated (and absorbed vs naive MLA); the flash kernel on three
           new paths, hubert-xlarge's forward (48 layers, non-causal, D
           80, 2 x 1024 frames), internvl2-2b's prefill (24 layers, 256
           patches + 256 tokens, 4 prompts) and phi3.5-moe's prefill (cut
           to 8 of 32 layers: 83.7 GB whole, 4 x 256 tokens), every
           launch on the bf16 route, every call held to the plain version
           on its own inputs (2e-2 and the tile gate), the output gated
           against the "ref" path's in float32; jamba and phi3.5 at
           smoke size, paged against dense. The kernels line counts the
           launches of the serving and bf16 flash runs (the counts set
           to 0 just before each) and, apart, over the whole phase with
           its checks. Flash at the two new shapes is checked and timed
           with the other flash shapes
  train    training through the port's entry points: granite-8b at full
           width cut to 16 of 36 layers (3.89 B parameters, bf16 with f32
           AdamW moments, remat "full") taking 20 in-place steps of
           make_train_step through run_training on SyntheticLM at the
           launcher's batch 8 x 128, lr 1e-3 on the cosine schedule, every
           loss and grad norm finite and the loss falling (mean of the
           last 5 below the first 5's), step ms on the host clock, tok/s,
           peak memory and one warm step under torch.profiler;
           mamba2-1.3b whole (48 layers) through python -m
           repro_torch.launch.train, every logged loss finite, and two
           runs of 3 steps from one initial state equal bit for bit;
           float32 against float64 on the same weights at full width and
           2 layers (granite-8b, deepseek-v2-lite-16b with MoE capacity
           lifted, mamba2-1.3b): loss and aux within 1e-5 relative, every
           gradient within 1e-4 of its leaf's max, one AdamW update
           within 1e-5; the launcher at --smoke preempted at step 7 of
           12 and resumed, its last checkpoint equal bit for bit to an
           uninterrupted run's; examples/torch_quickstart.py --preset
           100m, which exits 0 only if its loss drops; flash under grad
           raising RuntimeError in bf16 and float32. No kernel launches
           (the reference trains on the plain attention, and flash has
           no backward); the kernels line's train_launches says so

Then one line ``{"kernels": [...]}``, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA's data sheet
BF16_FLOP_PER_S = 989e12         # dense bf16 on the tensor cores
CUDA_CORE_OP_PER_S = 67e12       # float32 outside the tensor cores
TOL = {"bfloat16": 2e-2, "float32": 2e-5}   # tests/test_kernels.py:95
#: flash vs "ref" prefill logits of full-depth granite-8b, both run in
#: float32 on the same weights (bf16 -> f32 is exact): relative RMS
#: difference. The kernel's own f32 error is about 5e-7 of a unit
#: attention output; 36 layers of random weights may grow it by orders of
#: magnitude and stay below 1e-3, while a wrong kernel (a mask, a scale, a
#: GQA row off) moves the logits by O(1). The bf16 value is printed, not
#: gated: there the two paths round at different places.
LOGITS_REL_RMS_TOL = 1e-3
#: paged vs dense first-decode logits, float32, 4 layers: the two engines
#: run the same arithmetic but for the attention of the prompt (flash in
#: the dense prefill, the plain masked branch in the paged chunks), whose
#: float32 difference is about 1e-6 of a logit
PAGED_REL_RMS_TOL = 1e-4
#: calls in one torch.profiler trace of a kernel's device time
PROFILED_CALLS = 20
#: traces taken of one window before a trace that stays short is flagged
TRACE_ATTEMPTS = 3
#: rounds of kernel, library, library, kernel in the copies' timing
COPY_ROUNDS = 5
#: the spin ahead of the calls whose issue time the host clock takes
#: (about 34 ms at the H100's 1.98 GHz)
HOST_SPIN_CYCLES = 1 << 26
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: runtime and driver calls that start device work
LAUNCH_CALL = re.compile(r"Launch|Memcpy|Memset")
#: spin kernels launched before and after a traced window, and the clock
#: cycles of each (about 66 us at the H100's 1.98 GHz)
SETTLING_CALLS = 8
SETTLING_SPIN_CYCLES = 1 << 17
#: bf16 flash against its plain version: the worst relative RMS
#: difference over the (64 rows, D) tiles of every head (ref.tile_rel_rms).
#: The bf16 rounding of P and of the output gives about 2.6e-3 (an
#: emulation of the kernel's rounding in plain PyTorch, bh 4 x S 2048);
#: one head's last kv tile skipped gives 0.13 there and more at shorter
#: lengths. The allclose at TOL alone lets such a fault pass at S 2048.
FLASH_TILE_REL_RMS_TOL = 1e-2
#: flash at the families phase's shapes, (bh, H, Hkv, sq, sk, D, causal):
#: hubert-xlarge's forward on 2 x 1024 frames, internvl2-2b's prefill of
#: 4 x (256 patches + 256 tokens)
FLASH_NEW_SHAPES = {
    "hubert-xlarge bh 32 S 1024 D 80 non-causal":
        (32, 16, 16, 1024, 1024, 80, False),
    "internvl2-2b bh 64/32 S 512 D 128 causal":
        (64, 16, 8, 512, 512, 128, True)}
GIB = 1 << 30


def record(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, from
    CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def traced(torch, fn, path: Path) -> list[dict]:
    """The events of one call of ``fn`` under torch.profiler, as its
    chrome trace at ``path`` holds them. The call is bracketed by
    SETTLING_CALLS spin kernels on each side: the card's traces lose the
    device events of the first and last few launches of a trace
    (PERF.md, Findings), and these are then the spins'."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(SETTLING_CALLS):
            torch.cuda._sleep(SETTLING_SPIN_CYCLES)
        fn()
        for _ in range(SETTLING_CALLS):
            torch.cuda._sleep(SETTLING_SPIN_CYCLES)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def window(events: list[dict], settling: int = SETTLING_CALLS
           ) -> tuple[list[dict], list[dict] | None]:
    """A trace of :func:`traced` without its settling spins: the device
    events (kernels, copies, memsets) of the call, and its runtime or
    driver calls that start device work but have no device event in the
    trace, matched by correlation id (each call's name and how many such
    calls of the window come after it; None when the trace holds no
    such call). The spins are the first and last ``settling`` calls."""
    calls = sorted((e for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and LAUNCH_CALL.search(e.get("name", ""))
                    and "correlation" in e.get("args", {})),
                   key=lambda e: e["ts"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not calls:
        return dev, None
    spins = {e["args"]["correlation"]
             for e in calls[:settling] + calls[len(calls) - settling:]}
    inner = calls[settling:len(calls) - settling]
    dev = [e for e in dev
           if e.get("args", {}).get("correlation") not in spins]
    seen = {e.get("args", {}).get("correlation") for e in dev}
    return dev, [{"call": e["name"], "calls_after": len(inner) - 1 - i}
                 for i, e in enumerate(inner)
                 if e["args"]["correlation"] not in seen]


def complete_trace(torch, fn, path: Path, is_complete) -> tuple[list, dict]:
    """Trace one call of ``fn`` until ``is_complete(device events)`` holds
    and no launch of the trace lacks its device event, at most
    TRACE_ATTEMPTS times. Returns the device events of the first complete
    trace (else of the last) and how the traces went. A trace that stays
    short is flagged in the record and on stderr, never averaged as if
    whole."""
    short = []
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        dev, missing = window(traced(torch, fn, path))
        ok = not missing and is_complete(dev)
        if ok:
            break
        short.append({"device_events": len(dev),
                      "missing_calls": (missing or [])[:8]})
    info = {"device_events": len(dev),
            "missing_events": None if missing is None else len(missing),
            "attempts": attempt, "complete": ok, "short_attempts": short}
    if not ok:
        print(f"warning: torch.profiler traces of {path.name} stayed short "
              f"after {attempt} attempts: {info}", file=sys.stderr, flush=True)
    return dev, info


def device_ms(torch, fn, iters: int, name: str | None = None
              ) -> tuple[float, dict]:
    """Device time of ``fn`` per call, from a torch.profiler trace of
    ``iters`` calls after a warm one, and how complete the trace was. With
    ``name``: the mean duration of the kernels whose name holds it (the
    kernel alone, without the wrapper's host work), of which the trace
    must hold exactly ``iters``. Without: every kernel, copy and memset of
    the calls over ``iters``; each kernel name must then come a whole
    number of times a call."""
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(iters):
            fn()

    def whole(dev):
        if name is not None:
            return sum(name in e["name"] for e in dev) == iters
        counts: dict[str, int] = {}
        for e in dev:
            counts[e["name"]] = counts.get(e["name"], 0) + 1
        return bool(counts) and all(c % iters == 0 for c in counts.values())

    dev, info = complete_trace(torch, calls, ROOT / "build" / "repro_torch"
                               / "trace_times.json", whole)
    if name is not None:
        dev = [e for e in dev if name in e["name"]]
    check(bool(dev), f"no device event ({name or 'any'}) in a trace of "
          f"{iters} calls")
    info["calls"] = iters
    return sum(e["dur"] for e in dev) / (iters if info["complete"]
                                         else len(dev)) / 1e3, info


def kernel_times(torch, fn, plain, library, iters: int, name: str) -> dict:
    """A kernel's event mean and device ms beside its plain version's and
    its library call's (``library`` None where there is none). A trace
    takes at most PROFILED_CALLS calls."""
    traced_calls = min(iters, PROFILED_CALLS)
    dev, dev_trace = device_ms(torch, fn, traced_calls, name)
    lib, lib_trace = (device_ms(torch, library, traced_calls) if library
                      else (None, None))
    return dict(
        ms=time_ms(torch, fn, iters), device_ms=dev, device_trace=dev_trace,
        plain_ms=time_ms(torch, plain, iters),
        library_ms=time_ms(torch, library, iters) if library else None,
        library_device_ms=lib, library_device_trace=lib_trace)


def host_us(torch, fn, calls: int = 20) -> float:
    """The host's time to issue one call of ``fn``, in us: the mean of
    ``calls`` calls queued behind a spin kernel that keeps the card busy
    for longer than they take to issue."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOST_SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def event_turns(torch, fns: dict, order: list[str], calls: int) -> dict:
    """The event mean (:func:`time_ms`) of ``calls`` calls of ``fns[who]``
    for each ``who`` of ``order`` in turn: each name's turns, in order."""
    turns = {who: [] for who in fns}
    for who in order:
        turns[who].append(time_ms(torch, fns[who], calls))
    return turns


def device_turns(dev: list[dict], name: str) -> dict:
    """Each call's device ms in a trace of calls in turns, in the order
    they ran: the kernels whose name holds ``name``, and every other device
    event (the library call's)."""
    dev = sorted(dev, key=lambda e: e["ts"])
    return {"kernel": [e["dur"] / 1e3 for e in dev if name in e["name"]],
            "library": [e["dur"] / 1e3 for e in dev if name not in e["name"]]}


def copy_times_in_turns(torch, fn, library, name: str,
                        rounds: int = COPY_ROUNDS, calls: int = 10) -> dict:
    """A copy kernel and its library call timed in turns: kernel, library,
    library, kernel, ``rounds`` times. An event turn is the mean of
    ``calls`` calls (:func:`time_ms`); a device turn is one call's device time in
    one torch.profiler trace of the calls in the same order (the kernels
    whose name holds ``name``; every other device event is the library
    call's). The medians, each turn's value and the spread."""
    import statistics
    fns = {"kernel": fn, "library": library}
    order = ["kernel", "library", "library", "kernel"] * rounds
    events = event_turns(torch, fns, order, calls)

    def in_order():
        for who in order:
            fns[who]()

    def whole(dev):
        k = sum(name in e["name"] for e in dev)
        return k == 2 * rounds and len(dev) - k == 2 * rounds

    in_order()
    torch.cuda.synchronize()
    dev, info = complete_trace(torch, in_order, ROOT / "build" / "repro_torch"
                               / "trace_turns.json", whole)
    device = device_turns(dev, name)
    check(all(device.values()), f"no device event of {name} or of its "
          "library call in a trace of the turns")

    def med(turns):
        return {w: statistics.median(v) for w, v in turns.items()}
    ev, dv = med(events), med(device)
    return dict(
        ms=ev["kernel"], library_ms=ev["library"],
        device_ms=dv["kernel"], library_device_ms=dv["library"],
        device_trace=info,
        turns={"order": "kernel, library, library, kernel", "rounds": rounds,
               "calls_a_event_turn": calls, "event_ms": events,
               "device_ms": device},
        spread={kind: {w: [min(v), max(v)] for w, v in turns.items()}
                for kind, turns in (("event_ms", events),
                                    ("device_ms", device))},
        no_slower_than_library={"event": ev["kernel"] <= ev["library"],
                                "device": dv["kernel"] <= dv["library"]})


def disassembler() -> str | None:
    """cuobjdump beside nvcc, or the one Triton's package carries."""
    import importlib.util
    from repro_torch.kernels import _build
    candidates = [Path(_build.nvcc()).parent / "cuobjdump"]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.submodule_search_locations:
        candidates += [Path(p) / "backends" / "nvidia" / "bin" / "cuobjdump"
                       for p in spec.submodule_search_locations]
    return next((str(c) for c in candidates if c.exists()), None)


def sass_counts(library: Path, opcode: str) -> dict:
    """How many SASS instructions of ``opcode`` each kernel of a built
    library holds, from ``cuobjdump -sass``; or that no disassembler was
    found."""
    tool = disassembler()
    if tool is None:
        return {"sass": "no disassembler found"}
    out = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts: dict[str, int] = {}
    name = None
    for line in out.splitlines():
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.search(rf"\b{opcode}\b", line):
            counts[name] += 1
    return {"tool": tool, "opcode": opcode, "per_kernel": counts}


def conflict_degree(n: int, w: int, stride: int) -> int:
    """The most distinct 4-byte words in one bank that a warp's read of the
    strided kernel touches: lanes on rows (i * stride) % n, one column,
    rows of w + 1 words (csrc/strided.cu)."""
    worst = 1
    for g0 in range(0, n, 32):
        for col in range(min(w, 32)):
            banks: dict[int, set] = {}
            for i in range(g0, min(g0 + 32, n)):
                addr = (i * stride % n) * (w + 1) + col
                banks.setdefault(addr % 32, set()).add(addr)
            worst = max(worst, max(len(a) for a in banks.values()))
    return worst


def attention_bound(bh, bhkv, sq, sk, d, causal, itemsize, flop_rate):
    """Least time (ms) for the work: q, k, v read once and o written once
    at the memory rate, or the products of the pairs the mask keeps at
    the peak rate of their type, whichever is larger."""
    moved = (2 * bh * sq + 2 * bhkv * sk) * d * itemsize
    pairs = (sum(min(r + 1, sk) for r in range(sq)) if causal else sq * sk)
    flops = 4 * d * pairs * bh          # q·k and p·v, 2 flops per MAC
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / flop_rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def device_busy(torch, fn, trace_path: Path,
                expected: dict[str, int] | None = None) -> dict:
    """Wall ms of one warm call of ``fn`` (host clock, ending in a
    synchronize), then the device's busy ms in another call traced by
    torch.profiler: the union of its kernel, memcpy and memset spans.
    ``expected`` gives, for a kernel name's substring, how many such
    kernels a call launches; the trace is taken again while it holds
    fewer, or while a launch in it lacks its device event."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    def whole(dev):
        return all(sum(k in e["name"] for e in dev) == n
                   for k, n in (expected or {}).items())

    dev, info = complete_trace(torch, fn, trace_path, whole)
    return {"wall_ms": wall_ms, **busy_from_trace(dev, wall_ms),
            "trace": {**info, "expected": expected}}


def busy_from_trace(events: list[dict], wall_ms: float) -> dict:
    busy_us, end = 0.0, float("-inf")
    by_name: dict[str, float] = {}
    for e in sorted(events, key=lambda e: e["ts"]):
        start, stop = e["ts"], e["ts"] + e["dur"]
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    busy_ms = busy_us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"device_busy_ms": busy_ms if events else None,
            "idle_share": 1 - busy_ms / wall_ms if events else None,
            "flash_ms": sum(v for k, v in by_name.items()
                            if "flash_wgmma" in k or "flash_fwd" in k) / 1e3,
            "top_kernels_ms": [[k[:80], v / 1e3] for k, v in top]}


def ptxas_summary(log: str) -> list[dict]:
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out.append({"kernel": name, "spill_stores": int(m.group(1)),
                        "spill_loads": int(m.group(2))})
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[-1]["static_smem"] = int(smem.group(1)) if smem else 0
    return out


def single_cycle(torch, n: int, gen, dev):
    """A chase array whose pointers form one random cycle through all n."""
    perm = torch.randperm(n, generator=gen, device=dev)
    a = torch.empty(n, dtype=torch.int32, device=dev)
    a[perm] = torch.roll(perm, -1).to(torch.int32)
    return a


def spread(torch, cycles) -> dict:
    c = cycles.double()
    return {"median": c.median().item(),
            "p90": torch.quantile(c, 0.9).item(), "n": c.numel()}


def finite_curve(name: str, curve: dict) -> dict:
    import math
    check(all(math.isfinite(v) and v >= 0 for v in curve.values()),
          f"{name} curve has a negative or non-finite value: {curve}")
    return {str(k): v for k, v in curve.items()}


def common_prefix(a: list, b: list) -> int:
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def checked(engine):
    """``engine`` (an engine or a fleet) with its books checked after
    every tick. The wrapper refers to the engine, so only the cycle
    collector frees the pair."""
    step = engine.step

    def step_and_check():
        live = step()
        engine.check_invariants()
        return live
    engine.step = step_and_check
    return engine


def f32_copy(T, params, cfg, layers: int | None = None):
    """(config, weights) in float32 over the first ``layers`` layers: a
    copy, the bf16 weights converted exactly."""
    layers = layers or cfg.num_layers
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32",
                                num_layers=layers)
    f32 = lambda t: t.float()
    return cfg32, T.TransformerLM(
        cfg32, embed=f32(params.embed), final_norm=f32(params.final_norm),
        head=None if params.head is None else f32(params.head),
        blocks=[{n: f32(t) for n, t in b.items()}
                for b in params.blocks[:layers]],
        frontend={n: f32(t) for n, t in params.frontend.items()})


def paged_vs_dense(torch, cfg, params, *, requests: int, slots: int,
                   max_len: int) -> dict:
    """The launcher's workload through the dense and the paged engine:
    each request's logits at its first decode step, compared by relative
    RMS, and the greedy tokens per uid."""
    from repro_torch.launch import serve
    from repro_torch.serve.engine import PagedServeEngine, ServeEngine

    def run(eng):
        seen: dict[int, "torch.Tensor"] = {}

        def sampler(logits):
            if logits.dim() == 2:           # a decode step: (slots, vocab)
                for slot, req in eng.active.items():
                    if len(req.generated) == 1 and req.uid not in seen:
                        seen[req.uid] = logits[slot].clone()
            return torch.argmax(logits, -1)
        eng.sampler = sampler
        for r in serve._workload(cfg, argparse.Namespace(
                requests=requests, max_len=max_len, seed=0)):
            eng.submit(r)
        tokens = {r.uid: r.generated for r in eng.run_to_completion()}
        return seen, tokens

    dense, dense_tokens = run(ServeEngine(cfg, params, max_slots=slots,
                                          max_len=max_len))
    paged, paged_tokens = run(PagedServeEngine(cfg, params, max_slots=slots,
                                               max_len=max_len))
    uids = sorted(dense)
    check(uids == sorted(paged) == list(range(requests)),
          "the engines did not decode the same requests")
    a = torch.stack([paged[u] for u in uids])
    b = torch.stack([dense[u] for u in uids])
    check(bool(torch.isfinite(a).all()), "paged logits not finite")
    return dict(requests=requests, decoded=len(uids),
                rel_rms=((a - b).norm() / b.norm()).item(),
                max_abs=(a - b).abs().max().item(),
                max_abs_dense=b.abs().max().item(),
                tol_rel_rms=PAGED_REL_RMS_TOL,
                uids_equal=sum(paged_tokens.get(u) == g
                               for u, g in dense_tokens.items()),
                tokens_equal=paged_tokens == dense_tokens)


def rmsnorm_phase(torch, dev, card: str) -> dict:
    """Check the rmsnorm kernel against its plain version on the card, then
    time it. Returns its kernel record; its launches on the serving path
    are filled in after that path has run."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn

    gen = torch.Generator(device=dev).manual_seed(4)

    def inputs(rows, d, dtype):
        x = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
        sc = (torch.randn((d,), generator=gen, device=dev) * 0.1 + 1
              ).to(dtype)
        return x, sc

    errs = {}
    # granite-8b's prefill batch (4 x 256) and decode batch (8) at d 4096,
    # mistral-large-123b's d 12288, and a d that is no multiple of 8
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for rows, d in ((1024, 4096), (8, 4096), (64, 12288), (256, 4097)):
            x, sc = inputs(rows, d, dtype)
            got = rn.rmsnorm(x, sc)
            torch.cuda.synchronize()
            want = ref.rmsnorm_ref(x, sc)
            err = (got.float() - want.float()).abs().max().item()
            peak = want.float().abs().max().item()
            if dname == "float32":
                ok, tol = err <= 1e-6 * peak, {"max_abs_over_max_ref": 1e-6}
            else:
                ulps = int(ref.bf16_ulp_distance(got, want).max())
                ok, tol = ulps <= 1, {"bf16_ulps": 1, "max_ulps": ulps}
            errs[(dname, rows, d)] = err
            record("check", kernel="rmsnorm", dtype=dname, shape=[rows, d],
                   vector_path=rn.vector_path(x, got), max_abs_err=err,
                   max_abs_ref=peak, tol=tol, ok=ok)
            check(ok, f"rmsnorm disagrees with its plain version ({dname}, "
                      f"{rows}x{d}): max abs {err}")
    x, sc = inputs(100, 4096, torch.bfloat16)
    try:
        rn.rmsnorm(x, sc, block_rows=64)
        raised = False
    except ValueError:
        raised = True
    record("check", kernel="rmsnorm", divisibility_value_error=raised)
    check(raised, "rmsnorm rows 100 with block_rows 64 did not raise")

    times = {}
    for rows in (1024, 65536):
        x, sc = inputs(rows, 4096, torch.bfloat16)
        iters = 200 if rows == 1024 else 20
        times[rows] = kernel_times(
            torch, lambda: rn.rmsnorm(x, sc), lambda: ref.rmsnorm_ref(x, sc),
            lambda: torch.nn.functional.rms_norm(x, (4096,), weight=sc,
                                                 eps=1e-6),
            iters, "rmsnorm_")
        times[rows].update(
            bound_ms=(2 * rows * 4096 + 4096) * 2 / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes")
        record("times", kernel="rmsnorm", dtype="bfloat16",
               shape=[rows, 4096], card=card, **times[rows])
    t = times[1024]
    return {"name": "rmsnorm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm.py:16",
            "launches": None,
            "max_abs_err": errs[("bfloat16", 1024, 4096)],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "library_device_ms": t["library_device_ms"],
            "shape": "bf16 x (1024, 4096), scale (4096,)",
            "times_65536x4096": times[65536], "card": card}


def paged_serving(torch, cfg, params, dense_tokens: dict, trace_dir: Path
                  ) -> dict:
    """Full-width granite-8b through the launcher's paged engine, on the
    dense phase's weights and workload; then a tight pool; then paged vs
    dense first-decode logits in float32 at 4 layers. Returns the first
    run's workload, geometry, tokens and ticks: the fleet phase's N=1
    oracle."""
    import contextlib
    import io

    import numpy as np

    from repro_torch.core.costmodel import kv_bytes_per_token
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.serve import paging
    from repro_torch.serve.engine import PagedServeEngine, ServeEngine

    kv_tok = kv_bytes_per_token(cfg)
    want_len = paging.choose_page_len(cfg, expected_tokens=768)

    def run(num_pages):
        args = argparse.Namespace(requests=8, slots=4, max_len=768, seed=0,
                                  engine="paged", page_len=None,
                                  num_pages=num_pages, prefill_chunk=None)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            eng = checked(serve._paged_engine(cfg, params, args))
            fa.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            res = serve._engine_run(cfg, params, args, engine=eng)
        print(out.getvalue(), end="", flush=True)
        printed = int(re.search(r"page_len=(\d+)", out.getvalue()).group(1))
        s = eng.stats()
        got = {r.uid: r.generated for r in res["finished"]}
        toks = sum(len(g) for g in got.values())
        rec = dict(requests=len(got), tokens=toks, ticks=s["steps"],
                   wall_ms=res["wall_s"] * 1e3,
                   tokens_per_s=toks / res["wall_s"],
                   page_len=eng.page_len, printed_page_len=printed,
                   num_pages=eng.alloc.num_pages, peak_pages=s["peak_pages"],
                   peak_pool_bytes=s["peak_pages"] * eng.page_len * kv_tok,
                   pool_bytes=eng.alloc.num_pages * eng.page_len * kv_tok,
                   kv_bytes_per_token=kv_tok,
                   preemptions=s["preemptions"],
                   max_slack_tokens=s["max_slack_tokens"],
                   pages_leaked=eng.alloc.allocated_pages,
                   flash_launches=fa.launches,
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   # bf16, reported and not gated: the dense prefill runs
                   # flash, the paged chunks the plain masked attention,
                   # and the two round at different places
                   uids_equal_to_dense_bf16=sum(
                       got.get(u) == g for u, g in dense_tokens.items()),
                   prefix_equal_to_dense_bf16={
                       uid: [common_prefix(got.get(uid, []), g), len(g)]
                       for uid, g in sorted(dense_tokens.items())})
        check(len(got) == 8 and all(
            len(r.generated) == r.max_new_tokens for r in res["finished"]),
            "the paged engine did not answer every request in full")
        check(all(0 <= t < cfg.vocab_size for g in got.values() for t in g),
              "paged engine tokens out of range")
        check(rec["pages_leaked"] == 0, f"{rec['pages_leaked']} pages leaked")
        check(rec["max_slack_tokens"] <= eng.page_len,
              f"slack {rec['max_slack_tokens']} above a page")
        check(printed == eng.page_len == want_len,
              f"page_len printed {printed}, engine {eng.page_len}, "
              f"choose_page_len {want_len}")
        check(fa.launches == 0,
              f"the paged run launched flash {fa.launches} times")
        return eng, rec, got

    eng, rec, got = run(None)
    record("paged", step="serve", max_len=768, slots=4, **rec)
    oracle = dict(requests=8, slots=4, max_len=768, seed=0, tokens=got,
                  ticks=rec["ticks"], page_len=eng.page_len,
                  num_pages=eng.alloc.num_pages,
                  tokens_per_s=rec["tokens_per_s"])

    # where the time goes: a warm window of 8 decode ticks, 4 slots busy
    prof = PagedServeEngine(cfg, params, max_slots=4, max_len=768)
    rng = np.random.default_rng(5)
    for uid in range(4):
        prof.submit(serve.Request(uid, rng.integers(
            cfg.vocab_size, size=200).astype(np.int32), 64))
    while len(prof.active) < 4:
        prof.step()

    def decode_window():
        for _ in range(8):
            prof.step()

    record("paged", step="profile_decode", batch=4, steps=8,
           **device_busy(torch, decode_window,
                         trace_dir / "trace_paged_decode.json"))
    del prof

    # a pool three requests' worst case deep: the workload must preempt
    worst = max(eng._worst_case_pages(r) for r in eng.finished)
    del eng
    tight, rec, _ = run(3 * worst + paging.SCRATCH_PAGES)
    record("paged", step="tight_pool", worst_case_pages=worst, **rec)
    check(rec["preemptions"] > 0, "the tight pool did not preempt")
    del tight

    # paged vs dense first-decode logits, float32, 4 layers
    cfg32, params32 = f32_copy(T, params, cfg, 4)
    rec = paged_vs_dense(torch, cfg32, params32, requests=4, slots=4,
                         max_len=768)
    record("paged", step="paged_vs_dense_f32", layers=4, **rec)
    check(rec["rel_rms"] <= PAGED_REL_RMS_TOL,
          f"paged vs dense f32 logits differ by {rec['rel_rms']} (rel RMS)")
    return oracle


#: the fleet phase's sizes: the launcher's ``_fleet_run`` workload (16
#: requests, prompts and new tokens in [4, 32) from seed 0) on three
#: replicas of 4 slots at max_len 96; a seeded chat/poisson trace; a
#: seeded fault campaign; and the float32 mixed fleet at 4 layers
FLEET_SIZE = dict(requests=16, slots=4, max_len=96, trace_rate=0.5,
                  trace_horizon=24, campaign_requests=12, campaign_rate=0.05,
                  f32_layers=4, f32_requests=8, f32_slots=2)


def fleet_phase(torch, dev, cfg, params, paged: dict, card: str,
                size: dict = FLEET_SIZE) -> dict:
    """The dissect→deploy loop through the port's fleet, on the paged
    phase's weights (one copy, shared by every replica): an N=1 fleet
    held bit for bit to the paged engine; GTX980 dissected on start and
    bound to a replica; a heterogeneous fleet (tpu_v5e, TeslaV100, the
    fresh GTX980) checked every tick and replayed; auto tiers on a seeded
    trace and a seeded fault campaign, each run twice; a float32 mixed
    fleet against N=1. Returns each kernel's launches over the phase."""
    import gc

    from repro_torch.core import tracecache
    from repro_torch.core.costmodel import kv_bytes_per_token
    from repro_torch.kernels import batch_cache as bc
    from repro_torch.kernels import dbuf_copy, memcpy, pchase, rmsnorm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import strided
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.profile import diffing, pipeline, store
    from repro_torch.serve.faults import FaultInjector, run_campaign
    from repro_torch.serve.fleet import (OUTCOME_CLASSES, FleetEngine,
                                         resolve_fleet_profile)
    from repro_torch.serve.frontend import FleetFrontend
    from repro_torch.serve.planner import plan_for_trace
    from repro_torch.serve.workload import (WorkloadSpec, generate_trace,
                                            replay_trace)

    mods = {"flash_attention": fa, "pchase": pchase, "memcpy": memcpy,
            "dbuf_copy": dbuf_copy, "strided": strided, "rmsnorm": rmsnorm,
            "batch_cache": bc}
    fa.reset_launches()
    for m in mods.values():
        m.launches = 0
    t_phase = time.perf_counter()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def release():
        """Free the device memory of fleets gone out of use (a checked
        fleet refers to itself, so only the cycle collector frees it)."""
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- 1. N=1: the paged engine's schedule, bit for bit ---------------------
    n1 = checked(FleetEngine(cfg, params, max_slots=paged["slots"],
                             max_len=paged["max_len"], replicas=1))
    for r in serve._workload(cfg, argparse.Namespace(**{
            k: paged[k] for k in ("requests", "max_len", "seed")})):
        n1.submit(r)
    t0 = time.perf_counter()
    n1.run_to_completion()
    sync()
    wall = time.perf_counter() - t0
    got = {r.uid: r.generated for r in n1.finished()}
    eng = n1.replicas[0].engine
    record("fleet", step="n1_oracle", requests=len(got),
           tokens=sum(map(len, got.values())), ticks=n1.ticks,
           paged_ticks=paged["ticks"], wall_ms=wall * 1e3,
           page_len=eng.page_len, num_pages=eng.alloc.num_pages,
           uids_equal_to_paged_bf16=sum(
               got.get(u) == g for u, g in paged["tokens"].items()),
           card=card)
    check(got == paged["tokens"],
          "the N=1 fleet's tokens differ from the paged engine's")
    check(n1.ticks == paged["ticks"],
          f"the N=1 fleet took {n1.ticks} ticks, the paged engine "
          f"{paged['ticks']}")
    check((eng.page_len, eng.alloc.num_pages)
          == (paged["page_len"], paged["num_pages"]),
          "the N=1 fleet's pages differ from the paged engine's")
    del n1, eng
    release()

    # -- 2. dissect on start --------------------------------------------------
    with tracecache.disabled():
        t0 = time.perf_counter()
        fresh = pipeline.dissect_device("GTX980", engine="torch", device=dev)
        dissect_s = time.perf_counter() - t0
    diff = diffing.diff_profiles(fresh, store.load_profile("GTX980"))
    bad = [r.field for r in diff if not r.ok]
    scan_launches = bc.launches
    record("fleet", step="dissect_on_start", gpu="GTX980",
           engine=fresh.engine, wall_s=dissect_s, timings=fresh.timings,
           rows=len(diff), failing_rows=bad, scan_launches=scan_launches,
           card=card)
    check(not bad, f"GTX980 dissected on start diffs in {bad}")
    check(scan_launches == 0, f"the dissection launched the scan "
          f"{scan_launches} times")

    # -- 3. a heterogeneous fleet: tpu_v5e, TeslaV100, the fresh GTX980 -------
    profiles = ["tpu_v5e", "TeslaV100", fresh]
    n_req, slots, max_len = size["requests"], size["slots"], size["max_len"]

    def workload(n):
        """The launcher's fleet workload, seed 0."""
        return [(r.prompt, r.max_new_tokens) for r in serve._workload(
            cfg, argparse.Namespace(requests=n, max_len=max_len, seed=0))]

    def stream(fleet, n):
        front = FleetFrontend(fleet)
        t0 = time.perf_counter()
        for uid, (prompt, n_new) in enumerate(workload(n)):
            front.submit_blocking(prompt, n_new, uid=uid)
        handles = front.run()
        sync()
        return front, handles, time.perf_counter() - t0

    def hetero():
        """One run of the heterogeneous fleet: what it decided and made."""
        fleet = checked(FleetEngine(cfg, params, max_slots=slots,
                                    max_len=max_len, profiles=profiles))
        _, handles, wall = stream(fleet, n_req)
        check(all(r.engine.params is params for r in fleet.replicas),
              "a replica holds its own weights")
        return dict(
            log=fleet.decision_log(), stats=fleet.stats(), wall=wall,
            violations=len(fleet.margin_violations()),
            tokens={h.uid: h.tokens for h in handles},
            answered=len(handles) == n_req and all(
                h.done and len(h.tokens) == h.request.max_new_tokens
                for h in handles),
            replicas=[{"name": r.name, "page_len": r.engine.page_len,
                       "pool": r.engine.alloc.num_pages,
                       "pool_bytes": r.engine.alloc.num_pages
                       * r.engine.page_len * kv_tok,
                       "inflight_bound": r.inflight_bound,
                       "finished": r.engine.stats()["finished"],
                       "steps": r.engine.steps,
                       "peak_pages": r.engine.peak_pages}
                      for r in fleet.replicas])

    kv_tok = kv_bytes_per_token(cfg)
    release()
    at_start = (torch.cuda.memory_allocated(dev) if dev.type == "cuda"
                else None)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    first = hetero()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    release()
    again = hetero()
    release()
    s, tokens = first["stats"], first["tokens"]
    toks = sum(map(len, tokens.values()))
    committed = FleetEngine(cfg, params, max_slots=slots, max_len=max_len,
                            profiles=["GTX980"]).replicas[0].engine
    committed_pages = (committed.page_len, committed.alloc.num_pages)
    del committed
    solo = FleetEngine(cfg, params, max_slots=slots, max_len=max_len,
                       replicas=1)
    solo_tokens = {h.uid: h.tokens for h in stream(solo, n_req)[1]}
    del solo
    record("fleet", step="heterogeneous", requests=len(tokens),
           tokens=toks, ticks=s["ticks"], wall_ms=first["wall"] * 1e3,
           tokens_per_s=toks / first["wall"],
           replay_wall_ms=again["wall"] * 1e3, replicas=first["replicas"],
           decisions=s["decisions"], migrations=s["migrations"],
           preemptions=s["preemptions"], pages_leaked=s["pages_leaked"],
           margin_violations=first["violations"],
           committed_gtx980=list(committed_pages),
           memory_allocated_at_start=at_start,
           max_memory_allocated=peak,
           param_bytes=sum(p.numel() * p.element_size()
                           for p in params.parameters()),
           uids_equal_to_n1_bf16=sum(solo_tokens.get(u) == g
                                     for u, g in tokens.items()),
           card=card)
    check(first["answered"], "the fleet did not answer every request in "
          "full")
    check(all(0 <= t < cfg.vocab_size for g in tokens.values() for t in g),
          "fleet tokens out of range")
    check(s["pages_leaked"] == 0, f"{s['pages_leaked']} pages leaked")
    check(first["violations"] == 0, "the router broke its margin")
    fresh_pages = (first["replicas"][2]["page_len"],
                   first["replicas"][2]["pool"])
    check(fresh_pages == committed_pages,
          f"the fresh GTX980 profile sizes pages {fresh_pages}, the "
          f"committed one {committed_pages}")
    check(again["log"] == first["log"],
          "the heterogeneous fleet's decision log diverged on replay")
    check(again["tokens"] == tokens,
          "the heterogeneous fleet's tokens diverged on replay")
    del first, again

    # -- 4. auto tiers on a seeded trace, and a seeded fault campaign ---------
    spec = WorkloadSpec(scenario="chat", arrival="poisson",
                        rate=size["trace_rate"],
                        horizon=size["trace_horizon"], seed=0,
                        max_len=max_len, vocab_size=cfg.vocab_size)
    trace = generate_trace(spec)
    tiered = []
    for _ in range(2):
        tf = checked(FleetEngine(cfg, params, max_slots=slots,
                                 max_len=max_len, profiles=profiles,
                                 tiers="auto"))
        front = FleetFrontend(tf)
        t0 = time.perf_counter()
        replay_trace(front, trace)
        sync()
        tiered.append((tf, front, time.perf_counter() - t0))
    (tf, front, wall), (tf2, front2, _) = tiered
    rep = front.slo.report()
    plan = plan_for_trace(cfg, trace, spec=resolve_fleet_profile(profiles[0]),
                          max_slots=slots, max_len=max_len)
    ts = tf.stats()
    record("fleet", step="tiers_auto", tiers=ts["tiers"],
           trace=trace.stats(), fingerprint=trace.fingerprint(),
           ticks=ts["ticks"], wall_ms=wall * 1e3, handoffs=ts["handoffs"],
           handoff_aborts=ts["handoff_aborts"], decisions=ts["decisions"],
           pages_leaked=ts["pages_leaked"], slo=rep.lines(),
           planned_residence_ticks=plan.predicted_residence_ticks,
           measured_residence_ticks=rep.mean_residence_ticks,
           planned_replicas=plan.replicas, card=card)
    check(ts["handoffs"] > 0, "the auto tiers made no handoff")
    check(generate_trace(spec).fingerprint() == trace.fingerprint(),
          "the trace is not a function of its spec")
    check(repr(front2.slo.report().key()) == repr(rep.key()),
          "the SLO report diverged on replay")
    check(tf2.decision_log() == tf.decision_log(),
          "the tiered decision log diverged on replay")
    check(ts["pages_leaked"] == 0, f"{ts['pages_leaked']} pages leaked")
    del tiered, tf, tf2, front, front2
    release()

    campaigns = []
    for _ in range(2):
        t0 = time.perf_counter()
        cf = checked(FleetEngine(cfg, params, max_slots=slots,
                                 max_len=max_len, profiles=profiles))
        report = run_campaign(cf, workload(size["campaign_requests"]),
                              FaultInjector.campaign(
                                  0, rate=size["campaign_rate"]))
        sync()
        campaigns.append((report, time.perf_counter() - t0))
    (a, wall), (b, _) = campaigns
    record("fleet", step="fault_campaign", seed=0,
           rate=size["campaign_rate"], requests=size["campaign_requests"],
           events=a.event_counts, outcomes=a.outcome_counts(),
           deaths=a.stats["deaths"], quarantines=a.stats["quarantines"],
           readmits=a.stats["readmits"], degrades=a.stats["degrades"],
           lost=a.stats["lost"], ticks=a.stats["ticks"],
           log_entries=len(a.log), pages_leaked=a.stats["pages_leaked"],
           wall_ms=wall * 1e3, streams_equal=a.streams == b.streams,
           card=card)
    check(sorted(a.outcomes) == list(range(size["campaign_requests"]))
          and set(a.outcomes.values()) <= set(OUTCOME_CLASSES),
          f"unclassified requests: {a.outcomes}")
    check(a.log == b.log, "the campaign's merged log diverged on replay")
    check(a.outcomes == b.outcomes, "the campaign's outcomes diverged")
    check(a.streams == b.streams, "the campaign's streams diverged")
    check(a.stats["pages_leaked"] == 0,
          f"{a.stats['pages_leaked']} pages leaked at drain")
    del campaigns, a, b, cf
    release()

    # -- 5. float32: a mixed fleet against N=1 --------------------------------
    layers = min(size["f32_layers"], cfg.num_layers)
    cfg32, params32 = f32_copy(T, params, cfg, layers)
    work32 = serve._workload(cfg32, argparse.Namespace(
        requests=size["f32_requests"], max_len=max_len, seed=0))

    def f32_run(**kw):
        f = checked(FleetEngine(cfg32, params32, max_slots=size["f32_slots"],
                                max_len=max_len, **kw))
        for r in work32:
            f.submit(serve.Request(r.uid, r.prompt, r.max_new_tokens))
        f.run_to_completion()
        return f, {r.uid: r.generated for r in f.finished()}

    mixed, mixed_tokens = f32_run(profiles=["tpu_v5e", "TeslaV100"])
    _, solo_tokens = f32_run(replicas=1)
    equal = sum(mixed_tokens.get(u) == g for u, g in solo_tokens.items())
    record("fleet", step="mixed_vs_n1_f32", layers=layers,
           requests=len(work32), uids_equal=equal,
           page_lens=[r.engine.page_len for r in mixed.replicas],
           finished_per_replica=[r.engine.stats()["finished"]
                                 for r in mixed.replicas],
           first_difference={u: common_prefix(mixed_tokens.get(u, []), g)
                             for u, g in solo_tokens.items()
                             if mixed_tokens.get(u) != g}, card=card)
    check(len(solo_tokens) == len(work32) and mixed_tokens == solo_tokens,
          "the float32 mixed fleet's tokens differ from N=1's")
    del mixed, params32

    # -- 6. launches over the phase -------------------------------------------
    launches = {name: m.launches for name, m in mods.items()}
    record("fleet", step="launches", launches=launches,
           seconds=time.perf_counter() - t_phase, card=card)
    check(launches["flash_attention"] == 0 and launches["batch_cache"] == 0,
          f"the fleet path launched a kernel: {launches}")
    return launches


#: the parallel phase's sizes: the launcher's fleet at --smoke on the
#: mesh; the smoke train state restored onto it; the pipeline at the
#: reference's tests/test_pipeline.py shapes (4 units of width 16, batch
#: 2, 8 microbatches) on one stage
PARALLEL_SIZE = dict(launcher=["--arch", "granite-8b", "--smoke",
                               "--engine", "fleet", "--mesh-shape", "1"],
                     restore_arch="granite-8b", pipeline_units=4,
                     pipeline_width=16, pipeline_batch=2, pipeline_micro=8)
#: the pipeline against the sequential model: outputs, and gradients
#: relative to their largest magnitude
PIPELINE_TOL = 1e-6


def parallel_phase(torch, dev, cfg, params, paged: dict, card: str,
                   size: dict = PARALLEL_SIZE) -> dict:
    """The port's parallelism on a 1-device mesh (a world-1 group of this
    process; NCCL on the card): the paged phase's weights and workload
    served with the pool on the mesh, its tokens and ticks bit for bit the
    paged engine's, the pool's storage unchanged every tick, and on the
    card a warm window of 8 decode ticks under torch.profiler; the
    launcher's fleet with ``--mesh-shape 1``; a smoke train state
    restored onto the mesh; ``pipeline_apply`` on one stage against the
    sequential model, with its gradients. The group is destroyed at the
    end. Returns each kernel's launches on the main path (the mesh
    engine's run, every count set to 0 just before it and read just
    after) and over the whole phase."""
    import contextlib
    import gc
    import io
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.benchmarks.serve_sharded import pool_ptrs
    from repro_torch.kernels import _build
    from repro_torch.kernels import batch_cache as bc
    from repro_torch.kernels import dbuf_copy, memcpy, pchase, rmsnorm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import strided
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import (make_production_mesh,
                                         make_serve_mesh, release_world)
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.pipeline import pipeline_apply, stack_stages
    from repro_torch.serve.engine import PagedServeEngine
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.loop import TrainState, init_state

    mods = {"flash_attention": fa, "pchase": pchase, "memcpy": memcpy,
            "dbuf_copy": dbuf_copy, "strided": strided, "rmsnorm": rmsnorm,
            "batch_cache": bc}
    phase = dict.fromkeys(mods, 0)

    def take() -> dict:
        """Each kernel's launches since the last call, added to the
        phase's; every count is then 0."""
        got = {n: m.launches for n, m in mods.items()}
        for n, m in mods.items():
            phase[n] += got[n]
            m.launches = 0
        fa.reset_launches()
        return got

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    take()
    t_phase = time.perf_counter()
    mesh = make_serve_mesh(1, device_type=dev.type)
    record("parallel", step="mesh", axes=list(mesh.mesh_dim_names),
           shape=list(mesh.shape), device_type=mesh.device_type,
           backend=str(dist.get_backend()), world=dist.get_world_size(),
           card=card)

    # -- 1. the paged phase's workload with the pool on the mesh --------------
    args = argparse.Namespace(requests=paged["requests"], slots=paged["slots"],
                              max_len=paged["max_len"], seed=paged["seed"],
                              engine="paged", page_len=None, num_pages=None,
                              prefill_chunk=None)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        eng = checked(serve._paged_engine(cfg, params, args, mesh))
    ptrs, moved = pool_ptrs(eng), []
    step = eng.step

    def step_in_place():
        live = step()
        if pool_ptrs(eng) != ptrs:
            moved.append(eng.steps)
        return live
    eng.step = step_in_place
    take()
    with contextlib.redirect_stdout(out):
        res = serve._engine_run(cfg, params, args, engine=eng)
    sync()
    path = take()
    print(out.getvalue(), end="", flush=True)
    got = {r.uid: r.generated for r in res["finished"]}
    s = eng.stats()
    toks = sum(map(len, got.values()))
    pool = {n: [str(p) for p in leaf.placements]
            for n, leaf in eng.cache.items() if sh.is_dtensor(leaf)}
    record("parallel", step="mesh1_serve", requests=len(got), tokens=toks,
           ticks=s["steps"], paged_ticks=paged["ticks"],
           wall_ms=res["wall_s"] * 1e3, tokens_per_s=toks / res["wall_s"],
           unsharded_tokens_per_s=paged["tokens_per_s"],
           gather_shards=eng.shards, page_len=eng.page_len,
           num_pages=eng.alloc.num_pages,
           pages_leaked=eng.alloc.allocated_pages, pool_placements=pool,
           ticks_pool_moved=moved, uids_equal_to_paged_bf16=sum(
               got.get(u) == g for u, g in paged["tokens"].items()),
           card=card)
    check(got == paged["tokens"],
          "the 1-device mesh's tokens differ from the paged engine's")
    check(s["steps"] == paged["ticks"],
          f"the 1-device mesh took {s['steps']} ticks, the paged engine "
          f"{paged['ticks']}")
    check((eng.page_len, eng.alloc.num_pages)
          == (paged["page_len"], paged["num_pages"]),
          "the 1-device mesh's pages differ from the paged engine's")
    check(eng.shards == 1, f"gather shards {eng.shards}, not 1")
    check(eng.alloc.allocated_pages == 0,
          f"{eng.alloc.allocated_pages} pages leaked")
    check(not moved, f"the pool moved on ticks {moved[:5]}")
    check(bool(pool) and all(sh.is_dtensor(eng.cache[n])
                             and eng.cache[n].device_mesh is mesh
                             for n in pool), "the pool is not on the mesh")
    del eng, res, step
    gc.collect()

    # where the time goes: a warm window of 8 decode ticks on the mesh, 4
    # slots busy, the shape of the paged phase's window
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        prof = PagedServeEngine(cfg, params, max_slots=4, max_len=768,
                                mesh=mesh)
        rng = np.random.default_rng(5)
        for uid in range(4):
            prof.submit(serve.Request(uid, rng.integers(
                cfg.vocab_size, size=200).astype(np.int32), 64))
        while len(prof.active) < 4:
            prof.step()

        def decode_window():
            for _ in range(8):
                prof.step()

        record("parallel", step="profile_decode", batch=4, steps=8,
               **device_busy(torch, decode_window,
                             _build.BUILD_DIR / "trace_mesh_decode.json"))
        del prof

    # -- 2. the launcher's fleet on the mesh ----------------------------------
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(size["launcher"] + ["--device", dev.type])
    lines = out.getvalue().splitlines()
    print(out.getvalue(), end="", flush=True)
    mesh_lines = [ln for ln in lines if ln.startswith("serve mesh:")]
    replicas = [ln for ln in lines if ln.startswith("replica ")]
    record("parallel", step="launcher_fleet", argv=size["launcher"],
           mesh_lines=mesh_lines, replica_lines=replicas, card=card)
    check(mesh_lines == ["serve mesh: {'model': 1} (1 devices, "
                         f"{dev.type} backend)"],
          f"the launcher's mesh line: {mesh_lines}")
    check(len(replicas) == 1 and "gather_shards=1" in replicas[0],
          f"the launcher's replica line: {replicas}")
    check(any(ln.startswith("pages: peak=") and " leaked=0 " in ln
              for ln in lines), "the launcher's fleet leaked pages")

    # -- 3. a smoke train state restored onto the mesh ------------------------
    scfg = configs.get_smoke_config(size["restore_arch"])
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_state(scfg, AdamWConfig(), gen, dev)
    for leaves in (state.opt_state["m"], state.opt_state["v"]):
        for t in leaves.values():          # moments a trained state holds
            t.copy_(torch.rand(t.shape, generator=gen, device=dev))
    state.step.fill_(3)
    pshard = sh.param_shardings(T.param_logical_axes(state.params),
                                dict(state.params.named_parameters()),
                                sh.ShardingCtx(mesh))
    shardings = TrainState(pshard, {"m": pshard, "v": pshard, "count": None},
                           None, None)
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 3, state)
        back, at = ckpt.restore(d, state, shardings=shardings)
    want, have = dict(ckpt.leaves(state)), dict(ckpt.leaves(back))
    meshed = [k for k, t in have.items() if sh.is_dtensor(t)]
    equal = all(torch.equal(sh.full_tensor(have[k]).detach(), t.detach())
                for k, t in want.items())
    on_mesh = all(have[k].device_mesh is mesh for k in meshed)
    record("parallel", step="restore_onto_mesh", arch=scfg.name,
           restored_step=at,
           leaves=len(want), dtensor_leaves=len(meshed), equal=equal,
           card=card)
    check(at == 3 and equal, "the restored state differs from the saved one")
    check(len(meshed) == 3 * len(pshard) and on_mesh,
          f"{len(meshed)} of {3 * len(pshard)} leaves came back on the mesh")
    del state, back, want, have

    # -- 4. the pipeline on one stage ------------------------------------------
    u, w, b, m = (size[k] for k in ("pipeline_units", "pipeline_width",
                                     "pipeline_batch", "pipeline_micro"))
    pmesh = make_production_mesh(shape=(1,), axes=("stage",),
                                 device_type=dev.type)
    gen = torch.Generator(device=dev).manual_seed(0)
    ws = torch.randn(u, w, w, generator=gen, device=dev) * 0.3
    x = torch.randn(m, b, w, generator=gen, device=dev)

    def stage_fn(p, h):
        for wi in p.reshape(-1, w, w):
            h = torch.tanh(h @ wi)
        return h

    stacked = stack_stages(ws, 1).clone().requires_grad_()
    xp = x.clone().requires_grad_()
    y = pipeline_apply(stage_fn, stacked, xp, mesh=pmesh)
    (y ** 2).sum().backward()
    ws2, xs = ws.clone().requires_grad_(), x.clone().requires_grad_()
    ref = stage_fn(ws2, xs)
    (ref ** 2).sum().backward()
    errs = {"y": (y - ref).abs().max().item(),
            "grad_w": ((stacked.grad[0] - ws2.grad).abs().max()
                       / ws2.grad.abs().max()).item(),
            "grad_x": ((xp.grad - xs.grad).abs().max()
                       / xs.grad.abs().max()).item()}
    record("parallel", step="pipeline", stages=1, units=u, width=w,
           batch=b, microbatches=m, errors=errs, tol=PIPELINE_TOL, card=card)
    check(all(math.isfinite(e) and e < PIPELINE_TOL for e in errs.values()),
          f"the pipeline differs from the sequential model: {errs}")

    # -- 5. launches, and the group torn down ---------------------------------
    sync()
    take()
    release_world()
    record("parallel", step="launches", launches=path, phase_launches=phase,
           group_destroyed=not dist.is_initialized(),
           seconds=time.perf_counter() - t_phase, card=card)
    check(not dist.is_initialized(), "the mesh's group is still up")
    check(not any(path.values()),
          f"the mesh engine's run launched a kernel: {path}")
    return path, phase


#: the harness's metrics that time their run (wall clocks and the rates
#: taken from them): two runs of the same records differ there and
#: nowhere else. The bench phase and tests/test_torch_bench.py compare
#: every other field of every metric.
BENCH_TIMING_METRICS = ("host_memcpy_gbps", "batched_engine_speedup",
                        "tokens_per_s_dense", "tokens_per_s_paged",
                        "tokens_per_s_n1_fleet", "tokens_per_s_hetero_fleet",
                        "scenario_wall_ms", "campaign_wall_ms")
#: the fields of a metric that two runs must share (``us`` is a timing)
BENCH_METRIC_FIELDS = ("name", "measured", "expected", "cmp", "tol", "unit",
                       "verdict")
#: the bench phase's two full runs of the harness: (torch device, jobs)
BENCH_RUNS = (("cuda", 4), ("cpu", 1))
#: experiment x device records of a full run
BENCH_RECORDS = 36
#: the least launches of each kernel that the card's run makes: memcpy
#: once to warm and twice timed (table6 x tpu_v5e), strided once a stride
#: (table8 x tpu_v5e)
BENCH_MIN_LAUNCHES = {"memcpy": 3, "strided": 6}
BENCH_TIMEOUT_S = 900


def masked_record(rec: dict) -> dict:
    """An artifact's record with its timings masked: ``elapsed_s``, each
    metric's ``us``, and all but the name of each metric in
    BENCH_TIMING_METRICS."""
    return {**{k: rec[k] for k in ("experiment", "device", "section",
                                   "artifact", "verdict", "error")},
            "metrics": [{"name": m["name"]}
                        if m["name"] in BENCH_TIMING_METRICS
                        else {k: m[k] for k in BENCH_METRIC_FIELDS}
                        for m in rec["metrics"]]}


def run_bench(torch_device: str, jobs: int, out: Path, trace_root: Path,
              only: tuple = ()) -> tuple[dict, float]:
    """One full run (not --quick) of the port's harness through its CLI,
    in a process of its own, strict; returns its artifact and seconds.
    Its stderr goes to ``out`` with the suffix ``.log``."""
    import os
    cmd = [sys.executable, "-m", "repro_torch.bench", "run", "--strict",
           "--no-csv", "--torch-device", torch_device, "--jobs", str(jobs),
           "--trace-cache", str(trace_root), "--out", str(out)]
    for name in only:
        cmd += ["--only", name]
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{path}" if path
               else str(SRC))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=BENCH_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    out.with_suffix(".log").write_text(proc.stderr)
    check(proc.returncode == 0,
          f"the harness on {torch_device} (--jobs {jobs}) exited "
          f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    return json.loads(out.read_text()), seconds


def tree_state(*dirs: str) -> dict:
    """(mtime, size) of every file under the repo's ``dirs``."""
    return {str(p.relative_to(ROOT)): (p.stat().st_mtime_ns, p.stat().st_size)
            for d in dirs for p in sorted((ROOT / d).rglob("*"))
            if p.is_file()}


def compare_bench(a: dict, b: dict, records: int) -> None:
    """The gates on two artifacts of the harness: ``records`` records in
    each, none a DEVIATION or an ERROR, the same records in the same
    order, every metric equal with the timings masked (:func:`masked_record`),
    and ``strided_kernel_matches_oracle`` true in ``a``."""
    for payload in (a, b):
        s = payload["summary"]
        check(len(payload["records"]) == records,
              f"{len(payload['records'])} records, not {records}")
        check(s["DEVIATION"] == 0 and s["ERROR"] == 0,
              f"the harness's run has failing records: {s}")
    order = [[(r["experiment"], r["device"]) for r in p["records"]]
             for p in (a, b)]
    check(order[0] == order[1], "the two runs' records come in different "
                                f"orders: {order}")
    differ = {}
    for ra, rb in zip(a["records"], b["records"]):
        ma, mb = masked_record(ra), masked_record(rb)
        if ma != mb:
            names = [x.get("name") for x, y in zip(ma["metrics"], mb["metrics"])
                     if x != y]
            differ[f"{ra['experiment']} x {ra['device']}"] = names or ma
    check(not differ, f"the runs' records differ, timings masked: {differ}")
    strided = [m["measured"] for r in a["records"] for m in r["metrics"]
               if m["name"] == "strided_kernel_matches_oracle"]
    check(strided == [True],
          f"strided_kernel_matches_oracle in the first run: {strided}")


def bench_phase(card: str, out_dir: Path | None = None,
                runs: tuple = BENCH_RUNS, only: tuple = (),
                records: int = BENCH_RECORDS,
                min_launches: dict = BENCH_MIN_LAUNCHES) -> dict:
    """The paper's experiments through the port's harness, twice in full
    mode (``runs``: the card with a spawned pool, then the CPU serially),
    each under a fresh trace-cache root; the artifacts go to ``out_dir``
    (``build/repro_torch/bench/``). Gates: :func:`compare_bench`, no file
    under experiments/ or docs/ changed, and each kernel's launches over
    the runs (counted by the wrappers' counters in the processes that
    launched, as the harness reports them) at least ``min_launches``.
    Returns each kernel's launches over the phase."""
    import tempfile

    from repro_torch.kernels import KERNELS
    out_dir = out_dir or ROOT / "build" / "repro_torch" / "bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    before = tree_state("experiments", "docs")
    done = []
    with tempfile.TemporaryDirectory(dir=out_dir) as traces:
        for torch_device, jobs in runs:
            out = out_dir / f"chip_smoke_{torch_device}_jobs{jobs}.json"
            payload, seconds = run_bench(torch_device, jobs, out,
                                         Path(traces) / f"{torch_device}"
                                         f"_jobs{jobs}", only)
            done.append((torch_device, jobs, payload, seconds, out))
    compare_bench(done[0][2], done[1][2], records)
    launches = {k: sum(d[2]["kernel_launches"][k] for d in done)
                for k in KERNELS}
    first = {m["name"]: m for r in done[0][2]["records"]
             for m in r["metrics"]}

    def measured(name):
        m = first.get(name)
        return m and {k: m[k] for k in ("measured", "cmp", "detail")}

    record("bench", runs=[
        {"torch_device": dev, "jobs": jobs, "seconds": seconds,
         "summary": payload["summary"], "records": len(payload["records"]),
         "kernel_launches": payload["kernel_launches"],
         "artifact": str(out.relative_to(ROOT)) if out.is_relative_to(ROOT)
         else str(out)}
        for dev, jobs, payload, seconds, out in done],
        masked=list(BENCH_TIMING_METRICS),
        host_memcpy_gbps=measured("host_memcpy_gbps"),
        batched_engine_speedup=measured("batched_engine_speedup"),
        launches=launches, card=card)
    check(tree_state("experiments", "docs") == before,
          "a run of the harness changed a file under experiments/ or docs/")
    for name, least in min_launches.items():
        check(launches[name] >= least,
              f"the harness launched {name} {launches[name]} times, "
              f"not at least {least}: its records did not come from the "
              "kernel")
    return launches


#: the families phase's sizes: the serve phase's workload (8 requests, 4
#: slots, max_len 768) and loop (4 x 256, 16 new) for deepseek-v2-lite
#: and mamba2 at full width; float32 copies at 4 layers; hubert's forward
#: on 2 x 1024 frames; internvl2's prefill of 256 patches + 256 tokens
#: and phi3.5's of 256 tokens, 4 prompts each, phi3.5 cut to 8 layers
#: (and to 2 in float32); jamba and phi3.5 at their smoke configs
FAMILIES_SIZE = dict(requests=8, slots=4, max_len=768, loop_batch=4,
                     loop_prompt=256, loop_gen=16, f32_layers=4,
                     f32_requests=4, audio_batch=2, audio_frames=1024,
                     prefill_batch=4, prefill_tokens=256, phi_layers=8,
                     phi_f32_layers=2, smoke_requests=8, smoke_slots=4,
                     smoke_max_len=96)


def families_phase(torch, dev, card: str, size: dict = FAMILIES_SIZE,
                   get_config=None) -> dict:
    """The other model families through the port's entry points:
    deepseek-v2-lite-16b (MLA + MoE) and mamba2-1.3b (SSD) served at full
    width and depth through the launcher's loop, dense and paged engines,
    and held paged against dense in float32 at 4 layers (MoE capacity
    lifted, so routing does not depend on the batch); MLA's naive and
    absorbed decode; the flash kernel on three new paths (hubert's
    non-causal forward at D 80, internvl2's prefill behind its vision
    front end, phi3.5-moe's prefill), every call held to its plain
    version on its own inputs and the model's output to the "ref" path;
    jamba and phi3.5 at smoke size, paged against dense. ``get_config``
    (default ``configs.get_config``) names the full-width configs.
    Returns each kernel's launches on the phase's main path (the serving
    runs and the bf16 flash runs, every count set to 0 just before each
    and read just after) and over the whole phase, checks included."""
    import gc
    import importlib

    from repro_torch import configs
    from repro_torch.core.costmodel import kv_bytes_per_token
    from repro_torch.kernels import KERNELS, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.serve import paging

    get_config = get_config or configs.get_config
    mods = {n: importlib.import_module(f"repro_torch.kernels.{n}")
            for n in KERNELS}
    path, phase = dict.fromkeys(mods, 0), dict.fromkeys(mods, 0)
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def release():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak() -> int | None:
        return torch.cuda.max_memory_allocated() if on_card else None

    def lift(cfg):
        return (dataclasses.replace(cfg, capacity_factor=float(
            cfg.num_experts)) if cfg.is_moe else cfg)

    def weights(cfg):
        t0 = time.perf_counter()
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               dev)
        sync()
        return params, time.perf_counter() - t0

    def take() -> tuple[dict, dict]:
        """Each kernel's launches, and flash's by route, since the last
        call, added to the phase's totals; every count is then 0."""
        got, routes = {n: m.launches for n, m in mods.items()}, dict(
            fa.route_launches)
        for n, m in mods.items():
            phase[n] += got[n]
            m.launches = 0
        fa.reset_launches()
        return got, routes

    def on_path(fn, *a, **kw):
        """One run of the phase's main path, every count set to 0 just
        before it and read just after: ``(result, launches, routes)``."""
        take()
        res = fn(*a, **kw)
        sync()
        got, routes = take()
        for n, k in got.items():
            path[n] += k
        return res, got, routes

    take()

    # -- 1. full-width serving: deepseek-v2-lite-16b and mamba2-1.3b ----------
    for arch in ("deepseek-v2-lite-16b", "mamba2-1.3b"):
        cfg = get_config(arch)
        release()
        params, seconds = weights(cfg)
        n_params = sum(p.numel() for p in params.parameters())
        record("families", step="init", arch=arch, layers=cfg.num_layers,
               d_model=cfg.d_model, params=n_params,
               param_bytes=sum(p.numel() * p.element_size()
                               for p in params.parameters()),
               kv_bytes_per_token=kv_bytes_per_token(cfg), seconds=seconds,
               memory_allocated=torch.cuda.memory_allocated() if on_card
               else None)
        check(n_params == T.count_params(cfg),
              f"{arch}: {n_params} parameters, not count_params'")

        loop_args = argparse.Namespace(batch=size["loop_batch"],
                                       prompt_len=size["loop_prompt"],
                                       gen=size["loop_gen"])
        variants = [("naive", cfg)]
        if cfg.use_mla:
            variants.append(("absorbed", dataclasses.replace(
                cfg, mla_absorbed=True)))
        loops = {}
        for name, c in variants:
            res, _, _ = on_path(serve._batch_loop, c, params, loop_args)
            toks = res["tokens"]
            loops[name] = toks
            b, p_len, gen = (loop_args.batch, loop_args.prompt_len,
                             loop_args.gen)
            record("families", step="loop", arch=arch,
                   mla=name if cfg.use_mla else None, batch=b, prompt=p_len,
                   gen=gen, prefill_ms=res["prefill_s"] * 1e3,
                   decode_ms=res["decode_s"] * 1e3,
                   decode_ms_per_step=res["decode_s"] * 1e3 / (gen - 1),
                   prefill_tokens_per_s=b * p_len / res["prefill_s"],
                   decode_tokens_per_s=b * (gen - 1) / res["decode_s"],
                   max_memory_allocated=peak(), card=card)
            check(tuple(toks.shape) == (b, gen) and 0 <= int(toks.min())
                  and int(toks.max()) < cfg.vocab_size,
                  f"{arch} {name} loop tokens out of range")
        if cfg.use_mla:
            record("families", step="mla_absorbed_vs_naive", arch=arch,
                   dtype=cfg.dtype, token_agreement=(
                       loops["absorbed"] == loops["naive"]).float()
                   .mean().item())

        want_len = paging.choose_page_len(cfg,
                                          expected_tokens=size["max_len"])
        for engine in ("dense", "paged"):
            release()
            args = argparse.Namespace(
                requests=size["requests"], slots=size["slots"],
                max_len=size["max_len"], seed=0, engine=engine,
                page_len=None, num_pages=None, prefill_chunk=None)
            eng = None
            if engine == "paged":
                eng = checked(serve._paged_engine(cfg, params, args))
            res, _, _ = on_path(serve._engine_run, cfg, params, args,
                                engine=eng)
            eng, finished = res["engine"], res["finished"]
            s = eng.stats()
            toks = sum(len(r.generated) for r in finished)
            rec = dict(requests=len(finished), tokens=toks, ticks=s["steps"],
                       wall_ms=res["wall_s"] * 1e3,
                       tokens_per_s=toks / res["wall_s"],
                       max_memory_allocated=peak())
            if engine == "paged":
                rec.update(page_len=eng.page_len,
                           num_pages=eng.alloc.num_pages,
                           peak_pages=s["peak_pages"],
                           preemptions=s["preemptions"],
                           max_slack_tokens=s["max_slack_tokens"],
                           pages_leaked=eng.alloc.allocated_pages)
                check(eng.page_len == want_len,
                      f"{arch}: page_len {eng.page_len}, choose_page_len "
                      f"{want_len}")
                check(rec["pages_leaked"] == 0 and
                      rec["max_slack_tokens"] <= eng.page_len,
                      f"{arch} paged books: {rec}")
            record("families", step=engine, arch=arch, slots=size["slots"],
                   max_len=size["max_len"], card=card, **rec)
            check(len(finished) == size["requests"] and all(
                len(r.generated) == r.max_new_tokens for r in finished),
                f"{arch}: the {engine} engine did not answer every request")
            check(all(0 <= t < cfg.vocab_size for r in finished
                      for t in r.generated),
                  f"{arch}: {engine} engine tokens out of range")
            del eng, res, finished

        # float32 at 4 layers, MoE capacity lifted: paged against dense
        cfg32, params32 = f32_copy(T, params, lift(cfg), size["f32_layers"])
        del params
        release()
        rec = paged_vs_dense(torch, cfg32, params32,
                             requests=size["f32_requests"],
                             slots=size["slots"], max_len=size["max_len"])
        extra = {}
        if cfg.use_mla:
            # naive and absorbed MLA decode on one prefilled cache
            prompt = torch.randint(
                0, cfg.vocab_size, (2, 64), device=dev,
                generator=torch.Generator(device=dev).manual_seed(4))
            logits, cache = T.prefill(params32, cfg32, {"tokens": prompt},
                                      max_len=72)
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            out = {}
            for name, c in (("naive", cfg32), ("absorbed", dataclasses.replace(
                    cfg32, mla_absorbed=True))):
                out[name], _ = T.decode(params32, c, {
                    k: v.clone() for k, v in cache.items()}, tok, 64)
            a, b = out["absorbed"], out["naive"]
            extra["absorbed_vs_naive_rel_rms"] = (
                (a - b).norm() / b.norm()).item()
        record("families", step="paged_vs_dense_f32", arch=arch,
               layers=size["f32_layers"], **rec, **extra)
        check(rec["tokens_equal"],
              f"{arch} f32: paged tokens differ from dense")
        check(rec["rel_rms"] <= PAGED_REL_RMS_TOL,
              f"{arch} f32: paged vs dense logits differ by {rec['rel_rms']}")
        check(extra.get("absorbed_vs_naive_rel_rms", 0) <= PAGED_REL_RMS_TOL,
              f"{arch} f32: absorbed vs naive MLA {extra}")
        del params32

    # -- 2. flash on the new paths --------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(5)

    def flash_path(arch, cfg, batch, run, layers_f32=None):
        """``run(cfg, params, batch)`` with flash in bf16 on the main path,
        each kernel call captured and held to the plain version on its own
        inputs; in float32, the output gated against the "ref" path's."""
        release()
        params, seconds = weights(cfg)
        calls = []
        real = ops.flash_attention

        def captured(q, k, v, **kw):
            o = real(q, k, v, **kw)
            calls.append((q, k, v, kw, o))
            return o
        ops.flash_attention = captured
        try:
            flash, got, routes = on_path(run, dataclasses.replace(
                cfg, attention_impl="flash"), params, batch)
        finally:
            ops.flash_attention = real
        launched = got["flash_attention"]
        errs, tiles, oks = [], [], []
        for q, k, v, kw, o in calls:
            want = fa.flash_attention_plain(
                q, k, v, num_q_heads=kw["num_q_heads"],
                num_kv_heads=kw["num_kv_heads"], causal=kw["causal"])
            tol = TOL[str(q.dtype).split(".")[1]]
            errs.append((o.float() - want.float()).abs().max().item())
            ok = torch.allclose(o.float(), want.float(), atol=tol, rtol=tol)
            if q.dtype == torch.bfloat16:
                tiles.append(ref.tile_rel_rms(o, want))
                ok = ok and tiles[-1] <= FLASH_TILE_REL_RMS_TOL
            oks.append(ok)
        shape = [tuple(t.shape) for t in calls[0][:3]] if calls else None
        causal = calls[0][3]["causal"] if calls else None
        del calls
        peak_bf16 = peak()
        cfg32, params32 = f32_copy(T, params, cfg, layers_f32)
        del params
        release()
        batch32 = {k: v.float() if v.is_floating_point() else v
                   for k, v in batch.items()}
        a = run(dataclasses.replace(cfg32, attention_impl="flash"), params32,
                batch32)
        b = run(dataclasses.replace(cfg32, attention_impl="ref"), params32,
                batch32)
        f32 = {"layers": cfg32.num_layers,
               "rel_rms": ((a - b).norm() / b.norm()).item(),
               "max_abs": (a - b).abs().max().item()}
        del params32, a, b
        n_attn = [k for k, _, _ in T.layer_plan(cfg)].count("attn")
        record("families", step="flash_path", arch=arch,
               layers=cfg.num_layers, attention_layers=n_attn,
               flash_shape=shape, causal=causal, flash_launches=launched,
               flash_route_launches=routes, calls_within_gates=sum(oks),
               max_abs_err=max(errs, default=None),
               worst_tile_rel_rms=max(tiles, default=None),
               tol=TOL[cfg.dtype], tol_tile_rel_rms=FLASH_TILE_REL_RMS_TOL,
               output_shape=list(flash.shape), f32_vs_ref=f32, tol_rel_rms_f32=LOGITS_REL_RMS_TOL,
               init_seconds=seconds, max_memory_allocated=peak_bf16,
               card=card)
        check(bool(torch.isfinite(flash).all()),
              f"{arch}: flash output not finite")
        check(len(oks) == n_attn and all(oks),
              f"{arch}: {len(oks)} flash calls, {sum(oks)} within the "
              f"gates, for {n_attn} attention layers")
        if on_card:
            check(launched == n_attn and routes[fa.ROUTES[
                cfg.activation_dtype]] == launched,
                  f"{arch}: flash launched {routes}, not {n_attn} times")
        check(f32["rel_rms"] <= LOGITS_REL_RMS_TOL,
              f"{arch}: f32 flash vs ref differ by {f32['rel_rms']}")
        return launched

    def forward_logits(c, p, batch):
        return T.forward(p, c, batch)[0]

    def prefill_logits(c, p, batch):
        return T.prefill(p, c, batch)[0]

    hubert = get_config("hubert-xlarge")
    frames = torch.randn((size["audio_batch"], size["audio_frames"],
                          hubert.frontend_dim), generator=gen, device=dev
                         ).to(hubert.activation_dtype)
    path_launches = {"hubert-xlarge": flash_path(
        "hubert-xlarge", hubert, {"frames": frames}, forward_logits)}

    vlm = get_config("internvl2-2b")
    b, s = size["prefill_batch"], size["prefill_tokens"]
    batch = {"patches": torch.randn((b, vlm.num_patches, vlm.frontend_dim),
                                    generator=gen, device=dev
                                    ).to(vlm.activation_dtype),
             "tokens": torch.randint(0, vlm.vocab_size, (b, s), device=dev,
                                     generator=gen)}
    path_launches["internvl2-2b"] = flash_path("internvl2-2b", vlm, batch,
                                               prefill_logits)

    phi = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b"),
                              num_layers=size["phi_layers"])
    batch = {"tokens": torch.randint(0, phi.vocab_size, (b, s), device=dev,
                                     generator=gen)}
    path_launches["phi3.5-moe-42b-a6.6b"] = flash_path(
        "phi3.5-moe-42b-a6.6b", phi, batch, prefill_logits,
        size["phi_f32_layers"])
    release()

    # -- 3. jamba and phi3.5 at smoke size: paged against dense ---------------
    for arch in ("jamba-1.5-large-398b", "phi3.5-moe-42b-a6.6b"):
        cfg = lift(configs.get_smoke_config(arch))
        params = T.init_params(cfg, torch.Generator().manual_seed(0),
                               "cpu").to(dev)
        rec = paged_vs_dense(torch, cfg, params,
                             requests=size["smoke_requests"],
                             slots=size["smoke_slots"],
                             max_len=size["smoke_max_len"])
        record("families", step="smoke_paged_vs_dense", arch=arch,
               layers=cfg.num_layers, d_model=cfg.d_model, **rec)
        check(rec["tokens_equal"] and rec["rel_rms"] <= PAGED_REL_RMS_TOL,
              f"{arch} smoke: paged vs dense {rec}")
        del params

    # -- 4. launches on the main path and over the phase ----------------------
    take()
    record("families", step="launches", launches=path, phase_launches=phase,
           flash_path_launches=path_launches,
           seconds=time.perf_counter() - t_phase, card=card)
    if on_card:
        check(path["flash_attention"] == sum(path_launches.values()) > 0
              and phase["flash_attention"] >= path["flash_attention"],
              f"the families phase's flash launches: {path}, {phase}")
    return path, phase


#: the train phase at full width on the card: granite-8b cut to 16 of 36
#: layers (8.25 B parameters whole, 99 GB of bf16 parameters and
#: gradients and f32 moments; 16 layers are 3.89 B, 46.7 GB) at the
#: launcher's batch 8 x 128; mamba2-1.3b whole through the launcher and
#: twice 3 steps for determinism; float32 against float64 at 2 layers;
#: the launcher's preempt and resume at --smoke; the quickstart twin
TRAIN_SIZE = dict(granite_layers=16, steps=20, batch=8, seq=128, lr=1e-3,
                  launcher=["--arch", "mamba2-1.3b", "--steps", "10",
                            "--log-every", "1"],
                  determinism_arch="mamba2-1.3b", determinism_steps=3,
                  f64_layers=2, f64_batch=2, f64_seq=64,
                  resume=["--arch", "granite-8b", "--smoke", "--steps", "12",
                          "--ckpt-every", "3", "--log-every", "3"],
                  preempt_at=7, quickstart=["--preset", "100m"],
                  timeout_s=600)
#: float32 against float64 on the same weights: loss and aux (relative),
#: every gradient leaf (of that leaf's max |g|), one AdamW update
F64_LOSS_REL_TOL = 1e-5
F64_GRAD_TOL = 1e-4
F64_UPDATE_TOL = 1e-5
TRAIN_STEP_LINE = re.compile(
    r"^step +(\d+) loss=(\S+) ce=(\S+) gnorm=(\S+) tok/s=([\d,]+) "
    r"stragglers=(\d+)$")
QUICKSTART_LINE = re.compile(r"^ +step +(\d+) +ce=(\S+) +\(([\d,]+) tok/s\)$")


def loss_falls(losses: list[float], n: int = 5) -> bool:
    """The mean of the last ``n`` losses below the mean of the first
    ``n`` (tests/test_training.py:148-154's criterion)."""
    return (len(losses) >= 2 * n
            and sum(losses[-n:]) / n < sum(losses[:n]) / n)


def parse_train_log(text: str) -> dict:
    """The launcher's lines: its ``arch=`` header, each ``step`` line's
    numbers and whether a ``done:`` line ended it."""
    head = re.search(r"^arch=(\S+) params=([\d,]+) devices=(\d+)$", text,
                     re.M)
    steps = [{"step": int(m[1]), "loss": float(m[2]), "ce": float(m[3]),
              "gnorm": float(m[4]), "tok_s": int(m[5].replace(",", "")),
              "stragglers": int(m[6])}
             for m in map(TRAIN_STEP_LINE.match, text.splitlines()) if m]
    return {"arch": head and head[1],
            "params": head and int(head[2].replace(",", "")),
            "steps": steps,
            "done": bool(re.search(r"^done: \d+ steps in ", text, re.M))}


def parse_quickstart_log(text: str) -> dict:
    rows = [m for m in map(QUICKSTART_LINE.match, text.splitlines()) if m]
    done = re.search(r"^done in \S+: ce (\S+) -> (\S+) ", text, re.M)
    return {"steps": [int(m[1]) for m in rows],
            "ce": [float(m[2]) for m in rows],
            "tok_s": [int(m[3].replace(",", "")) for m in rows],
            "first_last_ce": done and [float(done[1]), float(done[2])]}


def finite(xs) -> bool:
    return bool(xs) and all(math.isfinite(x) for x in xs)


def add_phase_launches(kernels: list[dict], phases: dict[str, dict]) -> None:
    """Each kernel record gains one field a phase: that phase's launches
    of the kernel (``{field: {kernel name: launches}}``)."""
    for k in kernels:
        for field, counts in phases.items():
            k[field] = counts[k["name"]]


def train_phase(torch, dev, card: str, size: dict = TRAIN_SIZE,
                get_config=None) -> dict:
    """Training through the port's entry points: granite-8b at full width
    (cut in depth, ``size["granite_layers"]``) taking ``steps`` in-place
    AdamW steps through ``run_training`` with a falling loss, one warm
    step profiled; mamba2-1.3b whole through ``python -m
    repro_torch.launch.train`` and bit-equal over two runs of 3 steps from
    one initial state; float32 against float64 (granite, deepseek with
    MoE capacity lifted, mamba2) on loss, aux, every gradient and one
    AdamW update; the launcher's preempt-and-resume against an
    uninterrupted run, bit for bit; the quickstart twin; flash refusing
    grad. Returns each kernel's launches on the phase's runs (every count
    set to 0 just before each and read just after), all 0 by design."""
    import gc
    import importlib
    import os
    import shutil

    import numpy as np

    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as T
    from repro_torch.optim import (AdamWConfig, adamw_update, cosine_schedule,
                                   global_norm)
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault import StepWatchdog, run_training
    from repro_torch.train.loop import init_state, loss_fn, make_train_step

    get_config = get_config or configs.get_config
    mods = {n: importlib.import_module(f"repro_torch.kernels.{n}")
            for n in KERNELS}
    path = dict.fromkeys(mods, 0)
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    work = ROOT / "build" / "repro_torch" / "train"
    env = dict(os.environ, PYTHONPATH=str(SRC))

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def release():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def on_path(fn, *a, **kw):
        """One run of the phase, every count set to 0 just before it and
        read just after (added to the phase's launches)."""
        for m in mods.values():
            m.launches = 0
        res = fn(*a, **kw)
        sync()
        for n, m in mods.items():
            path[n] += m.launches
            m.launches = 0
        return res

    def run(argv, name):
        """A subprocess from the checkout's root: (exit code, stdout)."""
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, *argv], env=env, cwd=ROOT,
                           capture_output=True, text=True,
                           timeout=size["timeout_s"])
        (work / f"{name}.log").write_text(p.stdout + p.stderr)
        return p.returncode, p.stdout, time.perf_counter() - t0

    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)

    # -- 1. granite-8b at full width, cut in depth ------------------------------
    release()
    cfg = dataclasses.replace(get_config("granite-8b"),
                              num_layers=size["granite_layers"])
    opt = AdamWConfig(lr=size["lr"])
    t0 = time.perf_counter()
    state = init_state(cfg, opt, gen(0), dev)
    sync()
    n_params = sum(p.numel() for p in state.params.parameters())
    record("train", step="init", arch=cfg.name, layers=cfg.num_layers,
           d_model=cfg.d_model, params=n_params, dtype=cfg.param_dtype,
           moments=opt.moment_dtype, remat=cfg.remat_policy if cfg.remat
           else None, seconds=time.perf_counter() - t0,
           memory_allocated=torch.cuda.memory_allocated() if on_card
           else None)
    steps, b, s = size["steps"], size["batch"], size["seq"]
    step = make_train_step(cfg, opt, lr_fn=cosine_schedule(
        size["lr"], warmup=max(1, steps // 20), total=steps), in_place=True)
    data = SyntheticLM(cfg.vocab_size, s, b, seed=1)

    def batch_at(i):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(i).items()}

    wd, hist = StepWatchdog(), []
    on_path(run_training, state, step, batch_at, num_steps=steps,
            watchdog=wd, on_metrics=lambda i, m: hist.append(
                (float(m["loss"]), float(m["grad_norm"]),
                 wd.last_duration)))
    losses = [h[0] for h in hist]
    step_ms = sorted(h[2] * 1e3 for h in hist[1:])
    med = step_ms[len(step_ms) // 2]
    rec = dict(steps=steps, batch=b, seq=s, first_loss=losses[0],
               last_loss=losses[-1], losses=losses,
               grad_norms=[h[1] for h in hist],
               first_step_ms=hist[0][2] * 1e3, median_step_ms=med,
               min_step_ms=step_ms[0], tokens_per_s=b * s / med * 1e3,
               stragglers=wd.stragglers,
               max_memory_allocated=torch.cuda.max_memory_allocated()
               if on_card else None, card=card)
    if on_card:
        nxt = [steps]

        def one_step():
            on_path(step, state, batch_at(nxt[0]))
            nxt[0] += 1
        rec["profile"] = device_busy(torch, one_step,
                                     work / "trace_train_step.json")
    record("train", step="granite", arch=cfg.name, layers=cfg.num_layers,
           **rec)
    check(finite(losses) and finite(rec["grad_norms"]),
          f"granite training: a loss or grad norm is not finite: {hist}")
    check(loss_falls(losses), f"granite training: the loss did not fall "
          f"(first 5 {losses[:5]}, last 5 {losses[-5:]})")
    del state, step
    release()

    # -- 2. mamba2-1.3b through the launcher; determinism in process -------------
    device_arg = ["--device", dev.type]
    rc, out, secs = run(["-m", "repro_torch.launch.train",
                         *size["launcher"], *device_arg], "launcher")
    log = parse_train_log(out)
    want_steps = int(size["launcher"][size["launcher"].index("--steps") + 1])
    record("train", step="launcher", argv=size["launcher"], exit_code=rc,
           seconds=secs, **log)
    check(rc == 0 and log["done"] and len(log["steps"]) == want_steps
          and finite([r["loss"] for r in log["steps"]]),
          f"the launcher's run: exit {rc}, {log}")

    cfg = get_config(size["determinism_arch"])
    state0 = init_state(cfg, opt, gen(0), dev)
    step = make_train_step(cfg, opt, lr_fn=cosine_schedule(
        size["lr"], warmup=1, total=size["determinism_steps"]),
        in_place=True)
    data = SyntheticLM(cfg.vocab_size, s, b, seed=1)
    runs = []
    for state in (state0.clone(), state0):
        on_path(run_training, state, step, batch_at,
                num_steps=size["determinism_steps"])
        runs.append(dict(ckpt.leaves(state)))
    a, bb = runs
    differ = [k for k in a if not torch.equal(a[k], bb[k])]
    record("train", step="determinism", arch=cfg.name, layers=cfg.num_layers,
           params=sum(p.numel() for p in state0.params.parameters()),
           steps=size["determinism_steps"], leaves=len(a),
           leaves_differing=len(differ), first_differing=differ[:5],
           max_memory_allocated=torch.cuda.max_memory_allocated()
           if on_card else None)
    check(not differ, f"{cfg.name}: two runs from one state differ in "
          f"{len(differ)} leaves, e.g. {differ[:5]}")
    del state0, state, runs, a, bb, step
    release()

    # -- 3. float32 against float64 on the same weights ---------------------------
    for arch in ("granite-8b", "deepseek-v2-lite-16b", "mamba2-1.3b"):
        c32 = dataclasses.replace(get_config(arch),
                                  num_layers=size["f64_layers"],
                                  dtype="float32", param_dtype="float32")
        if c32.is_moe:
            c32 = dataclasses.replace(c32, capacity_factor=float(
                c32.num_experts))
        c64 = dataclasses.replace(c32, dtype="float64", param_dtype="float64")
        p32 = T.init_params(c32, gen(0), dev).requires_grad_(True)
        p64 = T.from_named(c64, {k: p.detach().double() for k, p in
                                 p32.named_parameters()}
                           ).requires_grad_(True)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
            c32.vocab_size, size["f64_seq"], size["f64_batch"],
            seed=1).batch(0).items()}
        def loss_and_grads(p, c):
            names, leaves = zip(*p.named_parameters())
            total, m = loss_fn(p, c, batch)
            return m, dict(zip(names, torch.autograd.grad(total, leaves)))

        out = {label: on_path(loss_and_grads, p, c)
               for label, c, p in (("f32", c32, p32), ("f64", c64, p64))}
        (m32, g32), (m64, g64) = out.pop("f32"), out.pop("f64")
        rel = lambda a, b: abs(float(a) - float(b)) / max(abs(float(b)),
                                                          1e-30)
        loss_rel = rel(m32["loss"], m64["loss"])
        aux_rel = rel(m32["aux"], m64["aux"]) if c32.is_moe else 0.0
        grad_err = max(float((g32[k].double() - g).abs().max()) /
                       max(float(g.abs().max()), 1e-30)
                       for k, g in g64.items())
        del g32
        # one AdamW update of each model on the float64 gradients, leaf
        # by leaf (both models' moments at once would not fit beside
        # them): the gradients pre-scaled by the global-norm clip, the
        # update's own clip then idle
        scale = min(1.0, opt.clip_norm / max(float(global_norm(g64)), 1e-9))
        opt1 = AdamWConfig(lr=size["lr"], clip_norm=math.inf)
        named = {label: {k: t.detach() for k, t in p.named_parameters()}
                 for label, p in (("f32", p32), ("f64", p64))}
        update_err = 0.0
        for k, g in g64.items():
            new = {}
            for label, dt in (("f32", torch.float32), ("f64", torch.float64)):
                t = named[label][k]
                st = {"m": {k: torch.zeros_like(t)},
                      "v": {k: torch.zeros_like(t)},
                      "count": torch.zeros((), dtype=torch.int32,
                                           device=dev)}
                new[label] = adamw_update({k: (g * scale).to(dt)}, st,
                                          {k: t}, opt1, size["lr"])[0][k]
            update_err = max(update_err, float(
                (new["f32"].double() - new["f64"]).abs().max()))
            del new
        record("train", step="f32_vs_f64", arch=arch,
               layers=c32.num_layers, d_model=c32.d_model,
               params=sum(t.numel() for t in p32.parameters()),
               loss_f32=float(m32["loss"]), loss_f64=float(m64["loss"]),
               loss_rel=loss_rel, aux_f32=float(m32["aux"]),
               aux_f64=float(m64["aux"]), aux_rel=aux_rel,
               worst_grad_err_of_max=grad_err, update_max_abs=update_err,
               tol_loss_rel=F64_LOSS_REL_TOL, tol_grad=F64_GRAD_TOL,
               tol_update=F64_UPDATE_TOL)
        check(loss_rel <= F64_LOSS_REL_TOL and aux_rel <= F64_LOSS_REL_TOL,
              f"{arch}: f32 vs f64 loss {loss_rel}, aux {aux_rel}")
        check(grad_err <= F64_GRAD_TOL,
              f"{arch}: f32 vs f64 gradient {grad_err} of its max")
        check(update_err <= F64_UPDATE_TOL,
              f"{arch}: f32 vs f64 AdamW update {update_err}")
        del p32, p64, out, g64, named
        release()

    # -- 4. preempt and resume through the launcher --------------------------------
    whole, cut = work / "ckpt_whole", work / "ckpt_cut"
    base = ["-m", "repro_torch.launch.train", *size["resume"], *device_arg]
    rcs = [run(base + ["--ckpt-dir", str(whole)], "resume_whole")[0],
           run(base + ["--ckpt-dir", str(cut), "--preempt-at",
                       str(size["preempt_at"])], "resume_cut")[0]]
    cut_steps = ckpt.all_steps(str(cut))
    rcs.append(run(base + ["--ckpt-dir", str(cut)], "resume_rest")[0])
    last = ckpt.latest_step(str(whole))
    same = last is not None and last == ckpt.latest_step(str(cut))
    differ = []
    if same:
        with np.load(whole / f"step-{last:08d}.npz") as za, \
                np.load(cut / f"step-{last:08d}.npz") as zb:
            same = sorted(za.files) == sorted(zb.files)
            differ = [k for k in za.files if k in zb.files and
                      za[k].tobytes() != zb[k].tobytes()]
    record("train", step="resume", argv=size["resume"],
           preempt_at=size["preempt_at"], exit_codes=rcs,
           steps_before_resume=cut_steps, final_step=last,
           leaves_differing=len(differ))
    check(rcs[0] == 0 and rcs[1] != 0 and rcs[2] == 0,
          f"preempt and resume: exit codes {rcs}")
    check(same and not differ, f"the resumed run's final checkpoint differs "
          f"from the uninterrupted one's: {differ[:5]}")

    # -- 5. the quickstart twin ------------------------------------------------------
    rc, out, secs = run([str(ROOT / "examples" / "torch_quickstart.py"),
                         *size["quickstart"], *device_arg], "quickstart")
    q = parse_quickstart_log(out)
    rates = sorted(q["tok_s"])
    record("train", step="quickstart", argv=size["quickstart"], exit_code=rc,
           seconds=secs, first_last_ce=q["first_last_ce"],
           median_tokens_per_s=rates[len(rates) // 2] if rates else None,
           card=card)
    check(rc == 0 and q["first_last_ce"] is not None,
          f"the quickstart twin exited {rc}")

    # -- 6. flash refuses grad ----------------------------------------------------------
    raised = {}
    for dt in (torch.bfloat16, torch.float32):
        q_ = torch.randn((8, 128, 64), device=dev, generator=gen(1)).to(dt)
        k_ = torch.randn((2, 128, 64), device=dev, generator=gen(2)).to(dt)
        before = fa.launches
        try:
            fa.flash_attention(q_.requires_grad_(True), k_, k_,
                               num_q_heads=4, num_kv_heads=1)
            raised[str(dt)] = False
        except RuntimeError as e:
            raised[str(dt)] = "no backward" in str(e)
        raised[str(dt)] &= fa.launches == before
    record("train", step="flash_under_grad", raised=raised)
    check(all(raised.values()), f"flash under grad did not raise: {raised}")

    record("train", step="launches", launches=path,
           seconds=time.perf_counter() - t_phase, card=card)
    check(not any(path.values()), f"the train phase launched {path}: "
          "training runs no kernel of the port")
    return path


def measurement(torch, dev, card: str) -> list[dict]:
    """The paper's measurement path: check each kernel against its plain
    version, time it, then drive the path end to end with the launch
    counts set to 0 just before. Returns the kernels' records."""
    import math

    import numpy as np

    from repro_torch.benchmarks import table6_global_bw as t6
    from repro_torch.core import classic
    from repro_torch.core import pchase as chase
    from repro_torch.kernels import dbuf_copy as dbuf
    from repro_torch.kernels import memcpy as mc
    from repro_torch.kernels import ops
    from repro_torch.kernels import pchase as pc
    from repro_torch.kernels import strided as st

    gen = torch.Generator(device=dev).manual_seed(1)
    rng = np.random.default_rng(1)

    def exact(name, got, want, **info):
        ok = (got.dtype == want.dtype and got.shape == want.shape
              and torch.equal(got, want))
        record("check", kernel=name, exact=ok, **info)
        check(ok, f"{name} disagrees with its plain version ({info})")

    def randn(shape, dtype):
        if dtype == torch.int8:
            return torch.randint(-128, 128, shape, generator=gen, device=dev,
                                 dtype=torch.int8)
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # -- check: each kernel against its plain version, exactly ----------------
    for n, s in ((64, 4), (128, 8), (96, 12), (1024, 32)):
        a, k = pc.uniform_init(n, s, dev), 2 * n // s
        exact("pchase", pc.pchase_trace(a, iterations=k),
              pc.pchase_trace_plain(a, iterations=k),
              case=f"uniform n={n} s={s} k={k}")
    a = torch.from_numpy(rng.permutation(256).astype(np.int32)).to(dev)
    exact("pchase", pc.pchase_trace(a, iterations=300),
          pc.pchase_trace_plain(a, iterations=300),
          case="permutation n=256 k=300")
    a = pc.uniform_init(64, 4, dev)
    exact("pchase", pc.pchase_trace(a, 8, iterations=10),
          pc.pchase_trace_plain(a, 8, iterations=10),
          case="uniform n=64 s=4 k=10 start=8")
    chase_k = 1 << 16
    big = single_cycle(torch, 16 << 20, gen, dev)          # 64 MB of int32
    big_plain = pc.pchase_trace_plain(big, iterations=chase_k)
    exact("pchase", pc.pchase_trace(big, iterations=chase_k), big_plain,
          case=f"single-cycle permutation, 64 MB, k={chase_k}")
    big_cycles = pc.pchase_trace_cycles(big, iterations=chase_k)
    exact("pchase", big_cycles.indices, big_plain,
          case=f"pchase_trace_cycles, 64 MB, k={chase_k}")

    copy_cases = [((512, 128), 128), ((1024, 256), 256), ((256, 512), 64)]
    for dtype, cols in ((torch.float32, 1024), (torch.bfloat16, 2048),
                        (torch.int8, 4096)):
        x = randn((GIB // (cols * dtype.itemsize), cols), dtype)
        exact("memcpy", mc.memcpy(x), mc.memcpy_plain(x), dtype=str(dtype),
              shape=list(x.shape), block_rows=256)
        for shape, block in copy_cases:
            y = randn(shape, dtype)
            exact("memcpy", mc.memcpy(y, block_rows=block),
                  mc.memcpy_plain(y), dtype=str(dtype), shape=list(shape),
                  block_rows=block)
        del x
    # the bench path's copy (table6_global_bw x tpu_v5e, full mode)
    y = randn(t6.COPY_SHAPE, torch.float32)
    exact("memcpy", mc.memcpy(y, block_rows=t6.COPY_BLOCK_ROWS),
          mc.memcpy_plain(y), dtype="torch.float32", shape=list(y.shape),
          block_rows=t6.COPY_BLOCK_ROWS, path="bench")
    x1g = randn((GIB // 4096, 1024), torch.float32)
    for nb in (1, 2, 3, 4):
        exact("dbuf_copy", dbuf.dbuf_copy(x1g, num_buffers=nb),
              dbuf.dbuf_copy_plain(x1g, num_buffers=nb),
              shape=list(x1g.shape), num_buffers=nb)
    two = randn((32, 256), torch.float32)        # 32 KB: two blocks, two tiles
    exact("dbuf_copy", dbuf.dbuf_copy(two, block_rows=16, num_buffers=4),
          dbuf.dbuf_copy_plain(two, block_rows=16, num_buffers=4),
          shape=[32, 256], block_rows=16, num_buffers=4)
    # the edge routes: memcpy from a start one byte past 16-byte alignment
    # (its byte path) and an aligned size whose last batch is cut short;
    # dbuf_copy at sizes that end in an 80-byte tile and a 13-byte tail, over
    # fewer tiles than CTAs and over more, at every depth it takes
    unaligned = randn((333 * 77 + 1,), torch.int8)[1:].view(333, 77)
    ragged = randn((1021, 1027), torch.int8)
    for y, block in ((unaligned, 111), (ragged, 1021)):
        exact("memcpy", mc.memcpy(y, block_rows=block), mc.memcpy_plain(y),
              dtype="torch.int8", shape=list(y.shape), block_rows=block,
              start_mod_16=y.data_ptr() % 16, bytes_mod_16=y.numel() % 16)
    tile = dbuf._library().repro_dbuf_tile_bytes()
    for tiles in (3, 301):
        n = tiles * tile + 5 * 16 + 13
        y = randn((1, n), torch.int8)
        for nb in range(1, dbuf._library().repro_dbuf_max_buffers() + 1):
            exact("dbuf_copy", dbuf.dbuf_copy(y, block_rows=1, num_buffers=nb),
                  dbuf.dbuf_copy_plain(y, block_rows=1, num_buffers=nb),
                  dtype="torch.int8", shape=[1, n], num_buffers=nb,
                  full_tiles=tiles, last_tile_bytes=80, tail_bytes=13)
    # dbuf_copy from a start 1, 3 and 15 bytes past 16-byte alignment (its
    # shifted stores), over 3 tiles and a ragged 80 + 13 bytes, at every depth
    n = 3 * tile + 5 * 16 + 13
    for offset in (1, 3, 15):
        y = randn((n + offset,), torch.int8)[offset:].view(1, n)
        for nb in range(1, dbuf._library().repro_dbuf_max_buffers() + 1):
            before = dbuf.launches
            got = dbuf.dbuf_copy(y, block_rows=1, num_buffers=nb)
            check(dbuf.launches == before + 1,
                  "an unaligned dbuf_copy took more than one launch")
            exact("dbuf_copy", got,
                  dbuf.dbuf_copy_plain(y, block_rows=1, num_buffers=nb),
                  dtype="torch.int8", shape=[1, n], num_buffers=nb,
                  start_mod_16=y.data_ptr() % 16, full_tiles=3,
                  last_tile_bytes=93)
    # the timed (128, 256) and its smaller row counts, and the (1024, 32)
    # of the measure phase's second stride curve; the times and the curves
    # run on the values checked here
    checked = {}
    for n, w in ((32, 256), (64, 256), (128, 256), (1024, 32)):
        x = checked[(n, w)] = randn((n, w), torch.float32)
        ok = all(torch.equal(st.strided_gather(x, stride=s),
                             st.strided_gather_plain(x, stride=s))
                 for s in range(1, 258))
        record("check", kernel="strided", shape=[n, w], strides="1..257",
               exact=ok)
        check(ok, f"strided disagrees with its plain version at {n}x{w}")

    def raises(fn) -> bool:
        try:
            fn()
        except ValueError:
            return True
        return False

    ones = torch.ones((100, 128), device=dev)
    bad = pc.uniform_init(64, 4, dev)
    bad[3] = 1000
    errors = {
        "memcpy rows % block_rows": raises(
            lambda: mc.memcpy(ones, block_rows=64)),
        "dbuf_copy rows % block_rows": raises(
            lambda: dbuf.dbuf_copy(ones, block_rows=64)),
        "dbuf_copy num_buffers 0": raises(
            lambda: dbuf.dbuf_copy(x1g, num_buffers=0)),
        "dbuf_copy num_buffers above shared memory": raises(
            lambda: dbuf.dbuf_copy(x1g, num_buffers=64)),
        "strided above one CTA's shared memory": raises(
            lambda: st.strided_gather(torch.ones((1024, 1024), device=dev),
                                      stride=3)),
        "pchase index outside the array": raises(
            lambda: pc.pchase_trace(bad, iterations=4)),
    }
    record("check", value_errors_on_cuda=errors)
    check(all(errors.values()), f"a ValueError was not raised: {errors}")

    # -- times: kernel, plain, library and bound ms ---------------------------
    times = {}
    clock_hz = big_cycles.elapsed_cycles / big_cycles.elapsed_ns * 1e9
    times["pchase"] = dict(
        ms=time_ms(torch, lambda: pc.pchase_trace(big, iterations=chase_k),
                   3, warmup=1),
        **dict(zip(("device_ms", "device_trace"), device_ms(
            torch, lambda: pc.pchase_trace(big, iterations=chase_k), 2,
            "pchase_kernel"))),
        plain_ms=time_ms(torch, lambda: pc.pchase_trace_plain(
            big, iterations=chase_k), 2, warmup=1),
        library_ms=None, library_device_ms=None,
        bound_ms=chase_k * 8 / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        latency_bound_ms=big_cycles.cycles.sum().item() / clock_hz * 1e3,
        cycles_per_access=spread(torch, big_cycles.cycles),
        sm_clock_mhz=clock_hz / 1e6,
        shape=f"int32 single-cycle permutation, 64 MB, {chase_k} accesses")
    del big, big_plain
    out = torch.empty_like(x1g)
    copy_bound = 2 * GIB / HBM_BYTES_PER_S * 1e3
    # the copies and copy_ in turns, since they sit within a few percent
    times["memcpy"] = dict(
        **copy_times_in_turns(torch, lambda: mc.memcpy(x1g),
                              lambda: out.copy_(x1g), "memcpy_kernel"),
        host_us=host_us(torch, lambda: mc.memcpy(x1g)),
        library_host_us=host_us(torch, lambda: out.copy_(x1g)),
        plain_ms=time_ms(torch, lambda: mc.memcpy_plain(x1g), 10),
        bound_ms=copy_bound, bound_by="bytes",
        shape="float32 (262144, 1024), 1 GiB, block_rows 256")
    times["dbuf_copy"] = dict(
        **copy_times_in_turns(torch, lambda: dbuf.dbuf_copy(x1g),
                              lambda: out.copy_(x1g), "dbuf_kernel"),
        host_us=host_us(torch, lambda: dbuf.dbuf_copy(x1g)),
        host_us_depth_8=host_us(
            torch, lambda: dbuf.dbuf_copy(x1g, num_buffers=8)),
        library_host_us=host_us(torch, lambda: out.copy_(x1g)),
        plain_ms=time_ms(torch, lambda: dbuf.dbuf_copy_plain(x1g), 10),
        bound_ms=copy_bound, bound_by="bytes",
        shape="float32 (262144, 1024), 1 GiB, block_rows 256, num_buffers 2")
    xs = checked[(128, 256)]
    idx = st.gather_index(128, 1, dev)
    times["strided"] = dict(
        **kernel_times(torch, lambda: st.strided_gather(xs, stride=1),
                       lambda: st.strided_gather_plain(xs, stride=1),
                       lambda: torch.index_select(xs, 0, idx), 200,
                       "strided_kernel"),
        bound_ms=2 * xs.numel() * 4 / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes", shape="float32 (128, 256), 128 KB, stride 1")
    for name, t in times.items():
        record("times", kernel=name, card=card, **t)
    del out

    # -- measure: the path end to end, counted --------------------------------
    mods = {"pchase": pc, "memcpy": mc, "dbuf_copy": dbuf, "strided": st}
    for m in mods.values():
        m.launches = 0
    backend = pc.kernel_trace_backend(device=dev)
    levels = {}
    # (footprint, stride, passes, accesses read): the later passes of L1
    # and L2 are warm; device memory is one cold pass, whose 65536 lines
    # (8 MB) would sit in L2 on a second pass
    for level, nbytes, stride, passes in (("L1", 16 << 10, 32, 16),
                                          ("L2", 8 << 20, 128, 2),
                                          ("device memory", 256 << 20, 4096,
                                           1)):
        n, s = nbytes // 4, stride // 4
        per_pass = n // s
        ct = pc.pchase_trace_cycles(pc.uniform_init(n, s, dev), (-s) % n,
                                    iterations=passes * per_pass)
        want = (torch.arange(per_pass, device=dev) * s) % n
        check(torch.equal(ct.indices[:per_pass].long(), want),
              f"{level} chase is not the uniform chase")
        read = ct.cycles[per_pass * (passes // 2):]
        tr = chase.fine_grained(backend, nbytes, stride)
        levels[level] = dict(footprint_bytes=nbytes, stride_bytes=stride,
                             accesses=passes * per_pass,
                             cycles=spread(torch, read),
                             sm_clock_mhz=ct.elapsed_cycles / ct.elapsed_ns
                             * 1e3,
                             differential_ns=tr.meta["per_access_ns"])
        record("measure", step="pchase_cycles", level=level, card=card,
               **levels[level])
    med = [levels[lv]["cycles"]["median"]
           for lv in ("L1", "L2", "device memory")]
    check(med[0] < med[1] < med[2],
          f"P-chase medians not ordered L1 < L2 < device memory: {med}")

    assumed_l1 = 256 << 10       # the SM's L1 + shared memory, an upper bound
    sizes = list(range(32 << 10, (320 << 10) + 1, 16 << 10))
    wong = chase.wong2010(backend, sizes, 128, passes=32)
    wong_params = classic.interpret_wong(wong, assumed_l1)
    record("measure", step="wong2010", stride_bytes=128, passes=32,
           tavg_ns=finite_curve("wong2010", wong),
           classic=dataclasses.asdict(wong_params),
           assumed_cache_bytes=assumed_l1, card=card)
    strides = [4 << i for i in range(15)]
    saav = chase.saavedra1992(backend, 1 << 20, strides, passes=16)
    saav_params = classic.interpret_saavedra(saav, 1 << 20, assumed_l1)
    record("measure", step="saavedra1992", array_bytes=1 << 20, passes=16,
           tavg_ns=finite_curve("saavedra1992", saav),
           classic=dataclasses.asdict(saav_params),
           assumed_cache_bytes=assumed_l1, card=card)

    gbps = {"1 GiB (262144, 1024) f32": ops.memcpy_throughput_gbps(
                (GIB // 4096, 1024), device=dev),
            "default (4096, 512) f32, 8 MB": ops.memcpy_throughput_gbps(
                device=dev)}
    record("measure", step="memcpy_throughput_gbps", gbps=gbps, card=card)
    check(all(math.isfinite(v) and v > 0 for v in gbps.values()),
          f"memcpy throughput not positive: {gbps}")

    # each depth after a turn of copy_ (not counted), and copy_ once more
    # at the end, all timed alike; 6 launches a depth
    dst = torch.empty_like(x1g)
    depth, copy_turns = {}, []
    for nb in (1, 2, 3, 4, 6, 8):
        copy_turns.append(time_ms(torch, lambda: dst.copy_(x1g), 5, warmup=1))
        ms = time_ms(torch, lambda: dbuf.dbuf_copy(x1g, num_buffers=nb), 5,
                     warmup=1)
        depth[nb] = {"ms": ms, "gbps": 2 * GIB / ms / 1e6,
                     "bytes_in_flight_per_sm": nb * tile}
    copy_turns.append(time_ms(torch, lambda: dst.copy_(x1g), 5, warmup=1))
    del dst
    copy_gbps = 2 * GIB / float(np.median(copy_turns)) / 1e6
    record("measure", step="dbuf_copy_depth", shape=list(x1g.shape),
           tile_bytes=tile, depth=depth, copy_ms_turns=copy_turns,
           copy_gbps=copy_gbps,
           depth1_below_depth2=depth[1]["gbps"] < depth[2]["gbps"],
           from_depth2_within_2pct_of_copy=all(
               d["gbps"] >= 0.98 * copy_gbps
               for nb, d in depth.items() if nb >= 2),
           card=card)

    # the probe's (128, 256) and a (1024, 32) whose 32 rows a warp reads
    # stay distinct up to stride 32, so that the conflicts reach 32-way
    for xc in (xs, checked[(1024, 32)]):
        n, w = xc.shape
        stride_curve = {}
        for s in (1, 2, 3, 4, 8, 16, 32, 33, 64, 128):
            dev, dev_trace = device_ms(torch, lambda: ops.strided_gather(
                xc, s), PROFILED_CALLS, "strided_kernel")
            stride_curve[s] = {
                "ms": time_ms(torch, lambda: ops.strided_gather(xc, s), 100),
                "device_ms": dev, "device_trace": dev_trace,
                "gcd_with_32": math.gcd(s, 32),
                "conflict_ways": conflict_degree(n, w, s)}
        record("measure", step="strided_stride_curve", shape=[n, w],
               curve=stride_curve, card=card)

    counts = {name: m.launches for name, m in mods.items()}
    record("measure", step="launches", launches=counts)
    check(all(counts.values()), f"a kernel of the path never ran: {counts}")

    sources = {"pchase": "pchase.py:27", "memcpy": "memcpy.py:26",
               "dbuf_copy": "dbuf_copy.py:23", "strided": "strided.py:24"}
    return [{"name": name, "route": "cuda",
             "source": f"src/repro_torch/kernels/csrc/{name}.cu",
             "replaces": f"src/repro/kernels/{sources[name]}",
             "launches": counts[name], "max_abs_err": 0.0, **times[name],
             "card": card} for name in mods]


#: lanes of the scan's check and time (inference._WAVE, one wave of probes)
SCAN_LANES = 16
#: accesses a lane in the scan's check against the numpy oracle and its time
SCAN_STEPS = 1 << 16
#: accesses a lane in the check against the plain version, whose step loop
#: launches some 30 PyTorch operations an access
SCAN_PLAIN_STEPS = 4096
#: the GPUs the dissection phase dissects, and the batched engine's least
#: speedup over the vector engine (benchmarks/profile_roundtrip.py:109)
DISSECT_GPUS = ("GTX560Ti", "GTX780", "GTX980", "TeslaV100")
MIN_BATCHED_SPEEDUP = 10.0


def scan_streams(np, geoms, seed: int) -> list:
    """Two lanes a geometry, SCAN_STEPS accesses each, at the probes' own
    sizes: a chase at 1.5x the structure's capacity, 2 passes with its line
    stride then 2 with a stride that does not tile (the simulator backends'
    np.resize stream), repeated; and a seeded random stream over 4x."""
    rng = np.random.default_rng(seed)
    out = []
    for g in geoms:
        c, b = g.size_bytes, g.line_bytes
        n = 3 * c // 2
        odd = 7 * b if n % (7 * b) else 5 * b
        tiled = np.resize((np.arange(-(-n // b), dtype=np.int64) * b) % n,
                          2 * -(-n // b))
        ragged = np.resize((np.arange(-(-n // odd), dtype=np.int64) * odd)
                           % n, 2 * -(-n // odd))
        out.append(np.resize(np.concatenate([tiled, ragged]), SCAN_STEPS))
        out.append(rng.integers(0, 4 * c // b, SCAN_STEPS).astype(np.int64)
                   * b)
    return out


def dissect_phase(torch, dev, card: str) -> dict:
    """The dissection half of the main path on the card: the batched
    engine's scan kernel against its plain version and the numpy oracle,
    then the main path with the launch count set to 0 just before it (the
    four GPUs dissected through the torch engine, and the torch backend's
    traces that take the scan), the twin of profile_roundtrip's batched
    speedup, and the kernel's times. Returns the kernel's record."""
    import numpy as np

    from repro_torch.core import cachesim, devices, tracecache
    from repro_torch.core.cachesim_torch import BatchCache
    from repro_torch.core.trace import PChaseConfig
    from repro_torch.kernels import batch_cache as bc
    from repro_torch.kernels import pchase as pc
    from repro_torch.kernels import ref
    from repro_torch.profile import diffing, pipeline, store

    # -- check: the scan kernel, exactly --------------------------------------
    names = sorted(devices.SIM_CACHES)
    geoms = [devices.SIM_CACHES[n]().geom for n in names]
    lane_geoms = [g for g in geoms for _ in range(2)]
    check(len(lane_geoms) == SCAN_LANES, f"{len(lane_geoms)} scan lanes")
    streams = scan_streams(np, geoms, seed=3)
    sim = BatchCache(lane_geoms, device=dev)
    full = sim.scan_inputs(list(enumerate(streams)))
    # the first SCAN_PLAIN_STEPS accesses of the same inputs, uniforms too
    short = {k: v[:, :SCAN_PLAIN_STEPS].contiguous()
             if k in ("sets", "lines", "valid", "u") else v
             for k, v in full.items()}
    hits = bc.batch_cache_scan(**full)
    short_hits = bc.batch_cache_scan(**short)
    want = ref.batch_cache_ref(**short)
    torch.cuda.synchronize()
    ok = torch.equal(short_hits, want) and torch.equal(
        hits[:, :SCAN_PLAIN_STEPS], short_hits)
    record("check", kernel="batch_cache", against="plain",
           lanes=SCAN_LANES, steps=SCAN_PLAIN_STEPS, exact=ok,
           geometries=names)
    check(ok, "batch_cache disagrees with its plain version")
    host = hits.cpu().numpy()
    oracle = {}
    for i, (g, addrs) in enumerate(zip(lane_geoms, streams)):
        if g.replacement.kind not in ("lru", "fifo"):
            continue
        c = cachesim.Cache(g)
        want_i = np.fromiter((c.access(int(a)) for a in addrs), dtype=bool,
                             count=len(addrs))
        oracle[f"{g.name}/{'chase' if i % 2 == 0 else 'random'}"] = {
            "exact": bool(np.array_equal(host[i], want_i)),
            "hit_rate": float(want_i.mean())}
    record("check", kernel="batch_cache", against="numpy Cache",
           steps=SCAN_STEPS, lanes=oracle)
    check(all(v["exact"] for v in oracle.values()),
          f"batch_cache disagrees with the numpy Cache: {oracle}")
    wide = BatchCache(cachesim.CacheGeometry("wide", 32, (1024,) * 64),
                      device=dev)
    try:
        wide.simulate([np.arange(64, dtype=np.int64) * 32], force_scan=True)
        raised = False
    except ValueError:
        raised = True
    record("check", kernel="batch_cache", value_error_too_wide=raised)
    check(raised, "a lane of 64 x 1024 ways did not raise ValueError")

    # -- dissect: the main path, counted --------------------------------------
    bc.launches = 0
    profiles, rows = {}, {}
    for gpu in DISSECT_GPUS:
        for engine in ("torch", "vector"):
            prof = pipeline.dissect_device(gpu, engine=engine, device=dev)
            committed = store.load_profile(gpu)
            diff = diffing.diff_profiles(prof, committed)
            bad = [r.field for r in diff if not r.ok]
            profiles[(gpu, engine)] = prof
            rows[(gpu, engine)] = len(diff)
            record("dissect", gpu=gpu, engine=engine, device=str(dev),
                   engine_version=prof.engine_version, rows=len(diff),
                   failing_rows=bad, stale=prof.is_stale(),
                   timings=prof.timings, card=card)
            check(not bad, f"{gpu} ({engine}) diffs from the committed "
                  f"profile in {bad}")
            check(not prof.is_stale(), f"{gpu} ({engine}) is stale")
        same = {k: v for k, v in profiles[(gpu, "torch")].to_json().items()
                if k not in ("engine", "engine_version", "timings")}
        check(same == {k: v for k, v in profiles[(gpu, "vector")].to_json()
                       .items() if k in same},
              f"{gpu}: the torch and vector engines' profiles differ")
    profile_launches = bc.launches

    # the probes the closed form does not take: a stride that does not tile
    # the array and a custom index stream, through the torch backend of
    # every lru/fifo structure, one at a time and as one batch, each trace
    # against the vector engine's
    traced = {}
    for name, g in zip(names, geoms):
        if g.replacement.kind not in ("lru", "fifo"):
            continue
        c, b = g.size_bytes, g.line_bytes
        n = 3 * c // 2
        odd = 7 * b if n % (7 * b) else 5 * b
        run = devices.sim_cache_backend(name, engine="torch", device=dev)
        vec = devices.sim_cache_backend(name, engine="vector")
        cfg = PChaseConfig(n, odd, 2 * -(-n // odd), 4, 2)
        custom = np.random.default_rng(len(name)).integers(
            0, 2 * c // 4, 2048).astype(np.int64)
        ccfg = PChaseConfig(4 * len(custom), 4, len(custom), 4, 0)
        got = [run(cfg), run(ccfg, indices=custom)]
        got += run.batch([(cfg, None), (ccfg, custom)])
        want = [vec(cfg), vec(ccfg, indices=custom)] * 2
        traced[name] = all(np.array_equal(x.latencies, y.latencies)
                           and np.array_equal(x.indices, y.indices)
                           for x, y in zip(got, want))
    trace_launches = bc.launches - profile_launches
    record("dissect", step="scan_probes", exact=traced,
           launches=trace_launches, card=card)
    check(all(traced.values()), f"torch backend traces differ: {traced}")
    launches = bc.launches
    record("dissect", step="launches", launches={
        "batch_cache": launches, "dissect_device": profile_launches,
        "scan_probes": trace_launches})
    check(launches > 0, "the scan kernel never ran on the dissection path")

    # -- the batched engine's speedup, as profile_roundtrip's gate ------------
    with tracecache.disabled():
        best = {}
        for engine in ("vector", "torch", "vector", "torch"):
            t0 = time.perf_counter()
            pipeline.dissect_structures("GTX980", engine=engine, device=dev)
            t = time.perf_counter() - t0
            best[engine] = min(best.get(engine, t), t)
    speedup = best["vector"] / best["torch"]
    record("dissect", step="batched_engine_speedup", gpu="GTX980",
           vector_s=best["vector"], torch_s=best["torch"], speedup=speedup,
           gate=MIN_BATCHED_SPEEDUP, card=card)
    check(speedup >= MIN_BATCHED_SPEEDUP,
          f"torch engine {speedup:.1f}x the vector engine, below "
          f"{MIN_BATCHED_SPEEDUP}x")

    # -- times: kernel, plain (smaller, scaled) and the two bounds ------------
    # a shared-memory round trip, from the card's own P-chase stamps at L1
    # (16 KB at a 32-byte stride, the later of 16 passes)
    l1 = pc.pchase_trace_cycles(pc.uniform_init(4096, 8, dev), 4088,
                                iterations=16 * 512)
    l1_cycles = l1.cycles[8 * 512:].double().median().item()
    clock_hz = l1.elapsed_cycles / l1.elapsed_ns * 1e9
    lanes_k = SCAN_LANES * SCAN_STEPS
    nbytes = sum(t.numel() * t.element_size() for t in full.values()) + lanes_k
    # this run's operations: an access compares its line with each way of
    # its set and takes the least of their stamps, two integer operations
    # a way, on the CUDA cores (at most their float32 rate)
    ways_hit = full["ways"].gather(1, full["sets"].long())
    ops = 2 * int((ways_hit * full["valid"]).sum())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / CUDA_CORE_OP_PER_S * 1e3
    plain_ms = time_ms(torch, lambda: ref.batch_cache_ref(**short), 1,
                       warmup=0)
    t = dict(
        ms=time_ms(torch, lambda: bc.batch_cache_scan(**full), 5, warmup=1),
        **dict(zip(("device_ms", "device_trace"), device_ms(
            torch, lambda: bc.batch_cache_scan(**full), 5,
            "batch_cache_kernel"))),
        plain_ms=plain_ms * SCAN_STEPS / SCAN_PLAIN_STEPS,
        plain_ms_measured=plain_ms,
        plain_shape=f"{SCAN_LANES} x {SCAN_PLAIN_STEPS} accesses, scaled "
                    f"x{SCAN_STEPS // SCAN_PLAIN_STEPS} to {SCAN_STEPS}",
        library_ms=None, library_device_ms=None,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        bound_bytes=nbytes, bytes_bound_ms=bytes_ms, bound_operations=ops,
        operations_bound_ms=ops_ms,
        latency_bound_ms=SCAN_STEPS * l1_cycles / clock_hz * 1e3,
        l1_round_trip_cycles=l1_cycles, sm_clock_mhz=clock_hz / 1e6,
        shape=f"{SCAN_LANES} lanes x {SCAN_STEPS} accesses, every "
              "registered geometry")
    record("times", kernel="batch_cache", card=card, **t)
    return {"name": "batch_cache", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/batch_cache.cu",
            "replaces": "src/repro/core/cachesim_jax.py:288",
            "launches": launches, "max_abs_err": 0.0, **t,
            "batched_engine_speedup": speedup, "card": card}


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py runs from the root of a checkout of the repo: "
              f"{SRC / 'repro_torch'} is missing", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; torch sees none",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import configs, resolve_device
    from repro_torch.kernels import KERNELS, _build
    from repro_torch.kernels import batch_cache as bc
    from repro_torch.kernels import dbuf_copy as dbuf
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import pchase as pc
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import strided as st
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    # -- device ---------------------------------------------------------------
    dev = resolve_device("cuda")
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    record("device", nvidia_smi=card, kind=kind,
           count=torch.cuda.device_count(), torch=torch.__version__,
           cuda=torch.version.cuda)

    # -- build ----------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build(KERNELS)
    falib = fa._library()
    pclib, dblib = pc._library(), dbuf._library()
    flash_sass = sass_counts(built["flash_attention"].path, "HGMMA")
    record("build", seconds=time.perf_counter() - t0,
           libraries={n: {"seconds": b.seconds,
                          "path": str(b.path.relative_to(ROOT)),
                          "ptxas": ptxas_summary(b.log)}
                      for n, b in built.items()},
           flash_f32_dynamic_smem_bytes={
               d: falib.repro_flash_attention_smem_bytes(d)
               for d in (16, 32, 64, 128)},
           flash_bf16_ctas={f"S {sq} D 128": {
               "warpgroups": falib.repro_flash_bf16_warpgroups(sq),
               "dynamic_smem_bytes": falib.repro_flash_bf16_smem_bytes(
                   sq, 128)}
               for sq in (101, 256, 2048)},
           flash_sass=flash_sass,
           pchase_carveout_percent=pclib.repro_pchase_carveout(),
           pchase_static_smem_bytes=pclib.repro_pchase_smem_bytes(),
           pchase_chunk=pclib.repro_pchase_chunk(),
           dbuf_tile_bytes=dblib.repro_dbuf_tile_bytes(),
           dbuf_max_buffers=dblib.repro_dbuf_max_buffers(),
           strided_max_smem_bytes=st._library().repro_strided_max_smem(),
           batch_cache_max_smem_bytes=bc._library().repro_batch_cache_max_smem())
    if "per_kernel" in flash_sass:
        hgmma = {k: v for k, v in flash_sass["per_kernel"].items()
                 if "flash_wgmma" in k}
        check(bool(hgmma) and all(hgmma.values()),
              f"the bf16 flash kernels hold no HGMMA instruction: {hgmma}")

    # -- check: kernel against its plain version ------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(bh, bhkv, sq, sk, d, dtype):
        return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for shape in ((bh, sq, d), (bhkv, sk, d), (bhkv, sk, d)))

    def skipped_kv_tile(q, k, v, want, h, hkv, causal):
        """The tile gate's reading of a kernel that skipped the last 64-row
        kv tile of the first head (its output from the plain version on
        k, v without those rows); None where there is one kv tile."""
        cut = (k.shape[1] - 1) // 64 * 64
        if cut == 0:
            return None
        faulted = want.clone()
        faulted[0] = fa.flash_attention_plain(
            q, k[:, :cut], v[:, :cut], num_q_heads=h, num_kv_heads=hkv,
            causal=causal)[0]
        return ref.tile_rel_rms(faulted, want)

    errs = {}
    # (bh, H, Hkv, sq, sk, d, causal): granite-8b's heads at the serving
    # path's lengths (the dense engine's prompts of 4-255 tokens, the
    # loop's 4 x 256) and beyond, a rectangular non-causal case, the small
    # head dims and the GQA ratios of tests/test_kernels.py
    cases = [(32, 32, 8, s, s, 128, True) for s in (37, 101, 255, 256, 2048)]
    cases += [(128, 32, 8, 256, 256, 128, True),
              (32, 32, 8, 128, 512, 128, False)]
    cases += [(8, 8, 8, 96, 96, d, True) for d in (16, 32, 64)]
    cases += [(h, h, hkv, 256, 256, 64, True)
              for h, hkv in ((8, 2), (4, 1), (16, 8))]
    # the families phase's new shapes: hubert-xlarge (16 heads, D 80,
    # non-causal, 2 x 1024 frames) and internvl2-2b (GQA 16/8, 4 x 512)
    cases += list(FLASH_NEW_SHAPES.values())
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        for bh, h, hkv, sq, sk, d, causal in cases:
            q, k, v = qkv(bh, bh // h * hkv, sq, sk, d, dtype)
            kw = dict(num_q_heads=h, num_kv_heads=hkv, causal=causal,
                      block_q=sq, block_k=sk)
            before = dict(fa.route_launches)
            got = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            route = next(r for r, n in fa.route_launches.items()
                         if n != before[r])
            want = fa.flash_attention_plain(q, k, v, num_q_heads=h,
                                            num_kv_heads=hkv, causal=causal)
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.allclose(got.float(), want.float(), atol=TOL[dname],
                                rtol=TOL[dname])
            tiles = {}
            if dname == "bfloat16":
                tiles = {"tile_rel_rms": ref.tile_rel_rms(got, want),
                         "tol_tile_rel_rms": FLASH_TILE_REL_RMS_TOL,
                         "skipped_kv_tile_rel_rms": skipped_kv_tile(
                             q, k, v, want, h, hkv, causal)}
                ok = ok and tiles["tile_rel_rms"] <= FLASH_TILE_REL_RMS_TOL
            errs[(dname, bh, sq, sk, d, h, hkv, causal)] = err
            record("check", kernel="flash_attention", dtype=dname,
                   shape=[bh, sq, sk, d], heads=[h, hkv], causal=causal,
                   route=route, max_abs_err=err, tol=TOL[dname], ok=ok,
                   **tiles)
            fault = tiles.get("skipped_kv_tile_rel_rms")
            check(fault is None or fault > FLASH_TILE_REL_RMS_TOL,
                  f"a skipped kv tile reads {fault}, inside the tile gate")
            check(route == fa.ROUTES[dtype],
                  f"{dname} flash took the {route} route")
            check(ok, f"flash_attention disagrees with its plain version "
                      f"({dname}, bh={bh}, sq={sq}, sk={sk}, d={d})")
    q = torch.zeros((32, 300, 128), device=dev, dtype=torch.bfloat16)
    try:
        fa.flash_attention(q, q[:8], q[:8], num_q_heads=32, num_kv_heads=8)
        raised = False
    except ValueError:
        raised = True
    record("check", kernel="flash_attention", divisibility_value_error=raised)
    check(raised, "seq 300 with block 256 did not raise ValueError")

    # -- times ----------------------------------------------------------------
    # bf16, causal, granite-8b's heads: one dense-engine prompt (bh 32 at a
    # ragged 101 and at 256), the loop's prefill (bh 128 x 256), and 2048
    times = {}
    for bh, s in ((32, 256), (32, 2048), (128, 256), (32, 101)):
        q, k, v = qkv(bh, bh // 4, s, s, 128, torch.bfloat16)
        kw = dict(num_q_heads=32, num_kv_heads=8, causal=True, block_q=s,
                  block_k=s)
        q4, k4, v4 = (t.view(bh // 32, -1, s, 128) for t in (q, k, v))
        iters = 10 if s == 2048 else 50
        t = kernel_times(
            torch, lambda: fa.flash_attention(q, k, v, **kw),
            lambda: fa.flash_attention_plain(q, k, v, num_q_heads=32,
                                             num_kv_heads=8, causal=True),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True, enable_gqa=True),
            iters, "flash_wgmma")
        t["bound_ms"], t["bound_by"] = attention_bound(
            bh, bh // 4, s, s, 128, True, 2, BF16_FLOP_PER_S)
        times[(bh, s)] = t
        record("times", kernel="flash_attention", dtype="bfloat16",
               shape=[bh, s, s, 128], causal=True, card=card, **t)

    # the same at the families phase's new shapes, bf16 (SDPA folds GQA
    # with enable_gqa)
    for label, (bh, h, hkv, sq, sk, d, causal) in FLASH_NEW_SHAPES.items():
        bhkv = bh // h * hkv
        q, k, v = qkv(bh, bhkv, sq, sk, d, torch.bfloat16)
        kw = dict(num_q_heads=h, num_kv_heads=hkv, causal=causal,
                  block_q=sq, block_k=sk)
        q4, k4, v4 = (t.view(bh // h, -1, t.shape[1], d) for t in (q, k, v))
        t = kernel_times(
            torch, lambda: fa.flash_attention(q, k, v, **kw),
            lambda: fa.flash_attention_plain(q, k, v, num_q_heads=h,
                                             num_kv_heads=hkv, causal=causal),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal, enable_gqa=True),
            20, "flash_wgmma")
        t["bound_ms"], t["bound_by"] = attention_bound(
            bh, bhkv, sq, sk, d, causal, 2, BF16_FLOP_PER_S)
        t["max_abs_err"] = errs[("bfloat16", bh, sq, sk, d, h, hkv, causal)]
        times[label] = t
        record("times", kernel="flash_attention", dtype="bfloat16",
               shape=[bh, sq, sk, d], heads=[h, hkv], causal=causal,
               path=label, card=card, **t)

    # the kernels that the serving phases do not launch, checked and timed
    # before them: torch.profiler traces taken after the serving phases'
    # large traces miss kernels
    rms_record = rmsnorm_phase(torch, dev, card)
    measured = measurement(torch, dev, card)
    torch.cuda.empty_cache()
    dissected = dissect_phase(torch, dev, card)
    torch.cuda.empty_cache()

    # -- serving: full-width granite-8b through the launcher ------------------
    cfg = dataclasses.replace(configs.get_config("granite-8b"),
                              attention_impl="flash")
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    record("serving", step="init", arch=cfg.name, layers=cfg.num_layers,
           d_model=cfg.d_model, params=n_params,
           seconds=time.perf_counter() - t0,
           memory_allocated=torch.cuda.memory_allocated())

    main_launches = 0
    rn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    loop_args = argparse.Namespace(batch=4, prompt_len=256, gen=16)
    fa.reset_launches()
    loop = serve._batch_loop(cfg, params, loop_args)
    launched = fa.launches
    main_launches += launched
    main_routes = dict(fa.route_launches)
    toks = loop["tokens"]
    record("serving", step="loop", batch=4, prompt=256, gen=16,
           prefill_ms=loop["prefill_s"] * 1e3,
           decode_ms=loop["decode_s"] * 1e3,
           tokens=int(toks.numel()), flash_launches=launched,
           flash_route_launches=dict(fa.route_launches), prefill_calls=1)
    check(launched == cfg.num_layers,
          f"loop launched flash {launched} times, not {cfg.num_layers} x 1")
    check(fa.route_launches["bf16_wgmma"] == launched,
          f"loop flash launches by route: {fa.route_launches}")
    check(tuple(toks.shape) == (4, 16) and 0 <= int(toks.min())
          and int(toks.max()) < cfg.vocab_size, "loop tokens out of range")

    dense_args = argparse.Namespace(requests=8, slots=4, max_len=768, seed=0,
                                    engine="dense")
    fa.reset_launches()
    run = serve._engine_run(cfg, params, dense_args)
    launched = fa.launches
    dense_routes = dict(fa.route_launches)
    main_routes = {r: n + dense_routes[r] for r, n in main_routes.items()}
    main_launches += launched
    eng, finished = run["engine"], run["finished"]
    dense_tokens = {r.uid: r.generated for r in finished}
    stats = eng.stats()
    record("serving", step="dense", requests=len(finished),
           tokens=sum(len(r.generated) for r in finished),
           ticks=stats["steps"], wall_ms=run["wall_s"] * 1e3,
           flash_launches=launched, flash_route_launches=dense_routes,
           prefill_calls=dense_args.requests,
           max_memory_allocated=torch.cuda.max_memory_allocated())
    check(len(finished) == 8 and all(
        len(r.generated) == r.max_new_tokens for r in finished),
        "the dense engine did not answer every request in full")
    check(all(0 <= t < cfg.vocab_size for r in finished for t in r.generated),
          "dense engine tokens out of range")
    check(launched == cfg.num_layers * dense_args.requests,
          f"dense engine launched flash {launched} times, not "
          f"{cfg.num_layers} x {dense_args.requests}")
    check(dense_routes["bf16_wgmma"] == launched,
          f"dense flash launches by route: {dense_routes}")

    # flash against the plain "ref" path on the same weights (not counted):
    # in bf16, printed; in float32 at full depth, gated
    ref_cfg = dataclasses.replace(cfg, attention_impl="ref")
    prompt = torch.randint(0, cfg.vocab_size, (1, 256), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(2))

    def logits_pair(p, flash_cfg):
        flash, _ = T.prefill(p, flash_cfg, {"tokens": prompt})
        plain, _ = T.prefill(p, dataclasses.replace(flash_cfg,
                                                    attention_impl="ref"),
                             {"tokens": prompt})
        diff = flash - plain
        return flash, {"rel_rms": (diff.norm() / plain.norm()).item(),
                       "max_abs": diff.abs().max().item(),
                       "max_abs_ref": plain.abs().max().item()}

    flash_logits, bf16 = logits_pair(params, cfg)
    fa.reset_launches()
    ref_loop = serve._batch_loop(ref_cfg, params, loop_args)
    agree = (ref_loop["tokens"] == toks).float().mean().item()
    ref_loop_launches = fa.launches
    cfg32, params32 = f32_copy(T, params, cfg)
    f32_memory = torch.cuda.memory_allocated()
    flash32, f32 = logits_pair(params32, cfg32)
    del params32
    torch.cuda.empty_cache()
    record("serving", step="flash_vs_ref", bf16_logits=bf16,
           greedy_token_agreement_bf16=agree, f32_logits=f32,
           tol_rel_rms_f32=LOGITS_REL_RMS_TOL,
           memory_allocated_with_f32_copy=f32_memory,
           ref_loop_flash_launches=ref_loop_launches)
    for logits in (flash_logits, flash32):
        check(bool(torch.isfinite(logits).all())
              and tuple(logits.shape) == (1, 1, cfg.vocab_size),
              "flash prefill logits not finite or of the wrong shape")
    check(f32["rel_rms"] <= LOGITS_REL_RMS_TOL,
          f"f32 flash prefill logits differ from ref by {f32['rel_rms']} "
          "(rel RMS)")
    check(ref_loop_launches == 0, "the ref path launched the flash kernel")

    # where the time goes: a warm prefill, and 8 warm decode steps
    prompts = torch.randint(0, cfg.vocab_size, (4, 256), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(3))
    prof_cache = {}

    def prefill():
        prof_cache["logits"], prof_cache["cache"] = T.prefill(
            params, cfg, {"tokens": prompts}, max_len=256 + 8)

    def decode():
        tok = torch.argmax(prof_cache["logits"][:, -1], dim=-1)[:, None]
        cache = prof_cache["cache"]
        for i in range(8):
            logits, cache = T.decode(params, cfg, cache, tok, 256 + i)
            tok = torch.argmax(logits[:, 0], dim=-1)[:, None]

    trace_dir = _build.BUILD_DIR
    record("serving", step="profile_prefill", batch=4, prompt=256,
           **device_busy(torch, prefill, trace_dir / "trace_prefill.json",
                         expected={"flash_wgmma": cfg.num_layers}))
    record("serving", step="profile_decode", batch=4, steps=8,
           **device_busy(torch, decode, trace_dir / "trace_decode.json"))

    del prof_cache, loop, run, eng, finished
    torch.cuda.empty_cache()
    oracle = paged_serving(torch, cfg, params, dense_tokens, trace_dir)
    serving_rmsnorm_launches = rn.launches
    torch.cuda.empty_cache()
    fleet_launches = fleet_phase(torch, dev, cfg, params, oracle, card)
    torch.cuda.empty_cache()
    parallel_launches, parallel_phase_launches = parallel_phase(
        torch, dev, cfg, params, oracle, card)
    del params
    torch.cuda.empty_cache()
    bench_launches = bench_phase(card)
    families_launches, families_phase_launches = families_phase(
        torch, dev, card)
    torch.cuda.empty_cache()
    train_launches = train_phase(torch, dev, card)

    t = times[(32, 256)]
    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:34",
        "launches": main_launches,
        "max_abs_err": errs[("bfloat16", 32, 256, 256, 128, 32, 8, True)],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "device_ms": t["device_ms"],
        "library_device_ms": t["library_device_ms"],
        "shape": "bf16 causal q (32, 256, 128), k/v (8, 256, 128)",
        "kernel_route": "bf16_wgmma", "launches_by_route": main_routes,
        "other_shapes": {(k if isinstance(k, str) else
                          f"bh {k[0]} S {k[1]}"): v
                         for k, v in times.items() if k != (32, 256)},
        "card": card}]
    rms_record["launches"] = serving_rmsnorm_launches
    kernels += [rms_record] + measured + [dissected]
    add_phase_launches(kernels, {
        "fleet_launches": fleet_launches, "bench_launches": bench_launches,
        "families_launches": families_launches,
        "families_phase_launches": families_phase_launches,
        "train_launches": train_launches,
        "parallel_launches": parallel_launches,
        "parallel_phase_launches": parallel_phase_launches})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
