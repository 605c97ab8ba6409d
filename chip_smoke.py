#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
nvidia-smi. It builds every kernel of the path from
``src/repro_torch/kernels/csrc/`` into ``build/repro_torch/``. Each phase
prints one JSON record on a line of its own; any failure raises and exits
non-zero. Phases:

  device   the card's name and power limit (nvidia-smi) and torch's name
  build    every kernel, one nvcc each, started together; ptxas registers,
           shared memory and spills
  check    each kernel against its plain PyTorch version on the card, at
           granite-8b's head shapes, in bfloat16 and float32
  times    kernel, plain version, the PyTorch library call and the bound
  serving  full-width granite-8b (36 layers, random bf16 weights from a
           seed) through the launcher's fixed-batch loop and its dense
           engine; every prefill must launch the flash kernel once per
           layer, and flash prefill logits must match the "ref" path's;
           then a warm prefill and a warm run of decode steps under
           torch.profiler, for the device's busy time beside the wall time

Then one line ``{"kernels": [...]}``, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA's data sheet
BF16_FLOP_PER_S = 989e12         # dense bf16 on the tensor cores
TOL = {"bfloat16": 2e-2, "float32": 2e-5}   # tests/test_kernels.py:95
#: flash vs "ref" prefill logits of full-depth granite-8b in bf16:
#: relative RMS difference. The two attention paths round to bf16 at
#: different places and 36 layers carry the difference on.
LOGITS_REL_RMS_TOL = 2e-2


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


def device_busy(torch, fn, trace_path: Path) -> dict:
    """Wall ms of one warm call of ``fn`` (host clock, ending in a
    synchronize), then the device's busy ms in a second call traced by
    torch.profiler: the union of its kernel, memcpy and memset spans."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace_path))
    return {"wall_ms": wall_ms, **busy_from_trace(trace_path, wall_ms)}


def busy_from_trace(trace_path: Path, wall_ms: float) -> dict:
    events = [e for e in json.loads(trace_path.read_text())["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
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
            "device_events": len(events),
            "flash_ms": sum(v for k, v in by_name.items()
                            if "flash_fwd" in k) / 1e3,
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
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
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
    built = _build.build(["flash_attention"])
    smem = fa._library().repro_flash_attention_smem_bytes
    record("build", seconds=time.perf_counter() - t0,
           libraries={n: {"seconds": b.seconds,
                          "path": str(b.path.relative_to(ROOT)),
                          "ptxas": ptxas_summary(b.log)}
                      for n, b in built.items()},
           flash_dynamic_smem_bytes={d: smem(d) for d in (16, 32, 64, 128)})

    # -- check: kernel against its plain version --------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(bh, bhkv, sq, sk, d, dtype):
        return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for shape in ((bh, sq, d), (bhkv, sk, d), (bhkv, sk, d)))

    errs = {}
    cases = [(1, s, s, True) for s in (37, 256, 2048)] + [
        (4, 256, 256, True), (1, 256, 512, False)]
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        for batch, sq, sk, causal in cases:
            q, k, v = qkv(32 * batch, 8 * batch, sq, sk, 128, dtype)
            kw = dict(num_q_heads=32, num_kv_heads=8, causal=causal)
            got = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            want = fa.flash_attention_plain(q, k, v, **kw)
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.allclose(got.float(), want.float(), atol=TOL[dname],
                                rtol=TOL[dname])
            errs[(dname, batch, sq, sk, causal)] = err
            record("check", kernel="flash_attention", dtype=dname,
                   shape=[32 * batch, sq, sk, 128], causal=causal,
                   max_abs_err=err, tol=TOL[dname], ok=ok)
            check(ok, f"flash_attention disagrees with its plain version "
                      f"({dname}, B={batch}, sq={sq}, sk={sk})")
    q = torch.zeros((32, 300, 128), device=dev, dtype=torch.bfloat16)
    try:
        fa.flash_attention(q, q[:8], q[:8], num_q_heads=32, num_kv_heads=8)
        raised = False
    except ValueError:
        raised = True
    record("check", kernel="flash_attention", divisibility_value_error=raised)
    check(raised, "seq 300 with block 256 did not raise ValueError")

    # -- times ----------------------------------------------------------------
    times = {}
    for s in (256, 2048):
        q, k, v = qkv(32, 8, s, s, 128, torch.bfloat16)
        kw = dict(num_q_heads=32, num_kv_heads=8, causal=True)
        iters = 50 if s == 256 else 10
        kernel_ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, **kw),
                            iters)
        plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v,
                                                                   **kw), iters)
        q4, k4, v4 = q[None], k[None], v[None]
        library_ms = time_ms(torch, lambda: torch.nn.functional.
                             scaled_dot_product_attention(
                                 q4, k4, v4, is_causal=True, enable_gqa=True),
                             iters)
        bound_ms, bound_by = attention_bound(32, 8, s, s, 128, True, 2,
                                             BF16_FLOP_PER_S)
        times[s] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                        bound_ms=bound_ms, bound_by=bound_by)
        record("times", kernel="flash_attention", dtype="bfloat16",
               shape=[32, s, s, 128], causal=True, card=card, **times[s])

    # -- serving: full-width granite-8b through the launcher -------------------
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
    torch.cuda.reset_peak_memory_stats()
    loop_args = argparse.Namespace(batch=4, prompt_len=256, gen=16)
    fa.launches = 0
    loop = serve._batch_loop(cfg, params, loop_args)
    launched = fa.launches
    main_launches += launched
    toks = loop["tokens"]
    record("serving", step="loop", batch=4, prompt=256, gen=16,
           prefill_ms=loop["prefill_s"] * 1e3,
           decode_ms=loop["decode_s"] * 1e3,
           tokens=int(toks.numel()), flash_launches=launched,
           prefill_calls=1)
    check(launched == cfg.num_layers,
          f"loop launched flash {launched} times, not {cfg.num_layers} x 1")
    check(tuple(toks.shape) == (4, 16) and 0 <= int(toks.min())
          and int(toks.max()) < cfg.vocab_size, "loop tokens out of range")

    dense_args = argparse.Namespace(requests=8, slots=4, max_len=768, seed=0,
                                    engine="dense")
    fa.launches = 0
    run = serve._engine_run(cfg, params, dense_args)
    launched = fa.launches
    main_launches += launched
    eng, finished = run["engine"], run["finished"]
    stats = eng.stats()
    record("serving", step="dense", requests=len(finished),
           tokens=sum(len(r.generated) for r in finished),
           ticks=stats["steps"], wall_ms=run["wall_s"] * 1e3,
           flash_launches=launched, prefill_calls=dense_args.requests,
           max_memory_allocated=torch.cuda.max_memory_allocated())
    check(len(finished) == 8 and all(
        len(r.generated) == r.max_new_tokens for r in finished),
        "the dense engine did not answer every request in full")
    check(all(0 <= t < cfg.vocab_size for r in finished for t in r.generated),
          "dense engine tokens out of range")
    check(launched == cfg.num_layers * dense_args.requests,
          f"dense engine launched flash {launched} times, not "
          f"{cfg.num_layers} x {dense_args.requests}")

    # flash against the plain "ref" path on the same weights (not counted)
    ref_cfg = dataclasses.replace(cfg, attention_impl="ref")
    prompt = torch.randint(0, cfg.vocab_size, (1, 256), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(2))
    flash_logits, _ = T.prefill(params, cfg, {"tokens": prompt})
    ref_logits, _ = T.prefill(params, ref_cfg, {"tokens": prompt})
    diff = flash_logits - ref_logits
    rel_rms = (diff.norm() / ref_logits.norm()).item()
    fa.launches = 0
    ref_loop = serve._batch_loop(ref_cfg, params, loop_args)
    agree = (ref_loop["tokens"] == toks).float().mean().item()
    record("serving", step="flash_vs_ref", logits_rel_rms=rel_rms,
           logits_max_abs=diff.abs().max().item(),
           logits_max_abs_ref=ref_logits.abs().max().item(),
           tol_rel_rms=LOGITS_REL_RMS_TOL,
           greedy_token_agreement=agree, ref_loop_flash_launches=fa.launches)
    check(bool(torch.isfinite(flash_logits).all())
          and tuple(flash_logits.shape) == (1, 1, cfg.vocab_size),
          "flash prefill logits not finite or of the wrong shape")
    check(rel_rms <= LOGITS_REL_RMS_TOL,
          f"flash prefill logits differ from ref by {rel_rms} (rel RMS)")
    check(fa.launches == 0, "the ref path launched the flash kernel")

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
           **device_busy(torch, prefill, trace_dir / "trace_prefill.json"))
    record("serving", step="profile_decode", batch=4, steps=8,
           **device_busy(torch, decode, trace_dir / "trace_decode.json"))

    t = times[256]
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:34",
        "launches": main_launches,
        "max_abs_err": errs[("bfloat16", 1, 256, 256, True)],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "shape": "bf16 causal q (32, 256, 128), k/v (8, 256, 128)",
        "card": card}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
