"""The traced sub-window: one ``torch.profiler`` session over a few steady
steps, its events kept in memory, reduced to the device's busy time, the
window's length, the device operations that took most time and the idle
gaps by what the host was doing.

The harness wraps the sub-window in a ``pb.window`` span and its calls
into the program in ``pb.*`` spans of its own (``record_function``); the
window's bounds are the ``pb.window`` span's. The card's traces have been
seen to lose the device events of the first and last few launches of a
session, so the session is bracketed by spin kernels that are not part of
the window (the settling of ``chip_smoke.py``'s ``traced``). A trace with
no device event at all fails: an idle share is never read from a blind
profiler.
"""

from __future__ import annotations

import sys
from contextlib import contextmanager

SETTLING_CALLS = 8
SETTLING_SPIN_CYCLES = 1 << 17
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
SHORT_GAP_S = 10e-6
TOP = 10


class BlindTrace(RuntimeError):
    """The profiler saw none of the card's work."""


@contextmanager
def span(name: str, on: bool = True):
    """A ``pb.<name>`` host span while tracing, else nothing."""
    if not on:
        yield
        return
    from torch.profiler import record_function
    with record_function(f"pb.{name}"):
        yield


def capture(torch, run) -> list:
    """The kineto events of one profiled call of ``run`` (which opens the
    ``pb.window`` span itself), bracketed by settling spins."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(SETTLING_CALLS):
            torch.cuda._sleep(SETTLING_SPIN_CYCLES)
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
        for _ in range(SETTLING_CALLS):
            torch.cuda._sleep(SETTLING_SPIN_CYCLES)
        torch.cuda.synchronize()
    return list(prof.profiler.kineto_results.events())


def _kind(e) -> str:
    """The event's kineto activity: ``kernel`` (any device event, copies
    and memsets included), ``gpu_user_annotation``, ``user_annotation``,
    ``cuda_runtime`` or ``cpu_op``. Read from ``activity_type`` where
    this PyTorch has it, else from the device type and the name."""
    at = getattr(e, "activity_type", None)
    if at is not None:
        return at()
    name = e.name()
    if "CUDA" in str(e.device_type()):
        return "gpu_user_annotation" if name.startswith("pb.") else "kernel"
    ua = getattr(e, "is_user_annotation", None)
    if name.startswith("pb.") or (ua is not None and ua()):
        return "user_annotation"
    if name.startswith("cuda"):
        return "cuda_runtime"
    return "cpu_op"


def _iv(e) -> tuple[float, float]:
    if hasattr(e, "start_ns"):
        s, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
    else:
        s, d = e.start_us() * 1e-6, e.duration_us() * 1e-6
    return s, s + d


def _union(ivs: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _innermost(items: list[tuple[float, float, str]], points: list[float]
               ) -> list[str | None]:
    """For each of the ascending ``points``, the name of the innermost of
    the nested host intervals ``items`` that holds it (None where none
    does): one sweep with a stack of the open intervals."""
    items = sorted(items)
    out, stack, i = [], [], 0
    for t in points:
        while i < len(items) and items[i][0] <= t:
            stack.append(items[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def reduce(events: list) -> dict:
    """busy_s, window_s, device_ops and idle_gaps of a captured trace."""
    windows = [_iv(e) for e in events
               if _kind(e) == "user_annotation"
               and e.name() == "pb.window"]
    if not windows:
        raise RuntimeError("the trace holds no pb.window span")
    w0, w1 = windows[0]
    device = [(e, *_iv(e)) for e in events
              if _kind(e) in DEVICE_ACTIVITIES]
    device = [(e, max(s, w0), min(t, w1)) for e, s, t in device
              if t > w0 and s < w1]
    if not device:
        raise BlindTrace("the profiled window holds no device event: the "
                         "profiler saw none of the card's work")
    busy = _union([(s, t) for _, s, t in device])
    busy_s = sum(t - s for s, t in busy)
    by_name: dict[str, float] = {}
    for e, s, t in device:
        by_name[e.name()[:80]] = by_name.get(e.name()[:80], 0.0) + (t - s)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    long = [(a + b) / 2 for a, b in idle if b - a >= SHORT_GAP_S]
    span_at = _innermost([(*_iv(e), e.name()) for e in events
                          if _kind(e) == "user_annotation"
                          and e.name().startswith("pb.")
                          and e.name() != "pb.window"], long)
    op_at = _innermost([(*_iv(e), e.name()) for e in events
                        if _kind(e) in ("cpu_op", "cuda_runtime",
                                                 "cuda_driver")], long)
    gaps: dict[str, float] = {}
    j = 0
    for a, b in idle:
        if b - a < SHORT_GAP_S:
            label = "gaps under 10 us"
        else:
            label = f"{span_at[j] or 'pb.none'}/{op_at[j] or 'no host op'}"
            j += 1
        gaps[label] = gaps.get(label, 0.0) + (b - a)
    launches = {e.correlation_id() for e in events
                if _kind(e) == "cuda_runtime"
                and "Launch" in e.name() and w0 <= _iv(e)[0] <= w1}
    seen = {e.correlation_id() for e, _, _ in device}
    missing = len(launches - seen)
    if missing:
        print(f"warning: {missing} of {len(launches)} launches in the traced "
              "window have no device event", file=sys.stderr, flush=True)
    top = lambda d: [[k, v] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"busy_s": busy_s, "window_s": w1 - w0,
            "device_events": len(device), "missing_launches": missing,
            "device_ops": top(by_name), "idle_gaps": top(gaps)}


def traced(torch, run, attempts: int = 3) -> dict:
    """:func:`reduce` of :func:`capture`, tried again while blind."""
    for attempt in range(1, attempts + 1):
        try:
            return reduce(capture(torch, run))
        except BlindTrace as err:
            print(f"warning: traced attempt {attempt}: {err}",
                  file=sys.stderr, flush=True)
            if attempt == attempts:
                raise
