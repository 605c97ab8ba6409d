"""Spans and counters of the port's own layers, off by default.

``enable(True)`` turns them on. Then each :func:`span` opens a
``torch.profiler`` range named ``repro.<name>`` (so any profiler trace
shows it, and the device work launched inside it), and records the span's
name, its host-clock start and end (``time.perf_counter_ns``), the index
of the innermost span open on the same thread when it began (its parent)
and a request id where it has one. :func:`count` adds to a named counter.
Both are kept in memory until :func:`drain` hands them over; nothing is
written anywhere. A span never synchronises the device: its times are
what the host did, and the device time under it comes from a profiler
trace.

Off, :func:`span` returns one shared no-op context and :func:`count`
returns at once: no clock is read, nothing is allocated and the profiler
is not touched.

Spans and counters see Python's calls only, so a replayed CUDA graph
adds nothing to them. The card's own count of a kernel comes from its
device events: :func:`kernels_in_window` profiles a call padded with
spin kernels on each side, and :func:`count_in_window` counts a name in
the events and says whether the count is whole.
"""

from __future__ import annotations

import functools
import threading
import time
from contextlib import nullcontext
from typing import NamedTuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

PREFIX = "repro."
#: spin kernels on each side of a kernel window, and the clock cycles of
#: each (about 2 us at the H100's 1.98 GHz). They detect a loss: what the
#: trace keeps of them says whether it lost any of the window's own
#: events at an end. The settling wait below prevents the loss.
WINDOW_PADDING = 1024
WINDOW_SPIN_CYCLES = 1 << 12
#: seconds the host waits with the card idle after the profiler starts
#: and before it stops. Kernel records reach the profiler late and in
#: batches, and its stop drops the batches not yet delivered: on an H100
#: (torch 2.11, CUDA 12.8) windows of 20k-400k kernels stopped at once
#: after their final synchronize lost the records of their last 94 to
#: 24,862 kernels in 6 of 15 traces (up to some 280 ms of work; once 341
#: records at the start instead), and none in 6 of 6 after a 0.5 s wait
WINDOW_SETTLE_S = 0.5
#: the name of ``torch.cuda._sleep``'s kernel in a trace
SPIN_KERNEL = "spin_kernel"

_OFF = nullcontext()
_on = False
_lock = threading.Lock()
_local = threading.local()
_spans: list[list] = []          # [name, start_ns, end_ns, parent, uid, index]
_counters: dict[str, int] = {}


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int | None           # None: still open when drained
    parent: int | None           # index of the enclosing span in the drain
    uid: int | None


def enable(on: bool) -> None:
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """One span while it is open."""
    __slots__ = ("rec", "range")

    def __init__(self, name: str, uid: int | None):
        self.rec = [name, 0, None, None, uid, None]

    def __enter__(self):
        rec, stack = self.rec, _stack()
        self.range = record_function(PREFIX + rec[0])
        self.range.__enter__()
        rec[3] = stack[-1][5] if stack else None
        with _lock:
            rec[5] = len(_spans)
            _spans.append(rec)
        stack.append(rec)
        rec[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.rec[2] = time.perf_counter_ns()
        _stack().pop()
        self.range.__exit__(*exc)
        return False


def span(name: str, uid: int | None = None):
    """A context that records the span ``name`` while tracing is on."""
    if not _on:
        return _OFF
    return _Open(name, uid)


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def drain() -> dict:
    """``{"spans": [Span, ...], "counters": {name: n}}`` recorded since
    the last drain, in the order the spans began; both are then cleared.
    A span still open is handed over without its end, and a span opened
    inside it later gets no parent."""
    global _spans, _counters
    with _lock:
        spans, counters = _spans, _counters
        _spans, _counters = [], {}
    out = [Span(*rec[:5]) for rec in spans]
    for rec in spans:
        rec[5] = None
    return {"spans": out, "counters": counters}


class WindowCount(NamedTuple):
    """The kernels of a padded window whose name holds a given name, and
    the padding spins left before and after the window's own events."""
    kernels: int
    before: int
    after: int

    @property
    def whole(self) -> bool:
        """Padding is left at both ends, so the trace lost none of the
        window's own events."""
        return self.before > 0 and self.after > 0


def count_in_window(names: list[str], name: str) -> WindowCount:
    """Count ``name`` in a padded window's device events, given as their
    kernel names in the order they ran. A trace loses device events at
    its ends; what it lost there are padding spins only while some are
    left at both ends. A window with no event of its own is not whole."""
    own = [i for i, n in enumerate(names) if SPIN_KERNEL not in n]
    before, after = ((own[0], len(names) - 1 - own[-1]) if own
                     else (len(names), 0))
    return WindowCount(sum(name in n for n in names), before, after)


def _pad() -> None:
    for _ in range(WINDOW_PADDING):
        torch.cuda._sleep(WINDOW_SPIN_CYCLES)


def _settle() -> None:
    torch.cuda.synchronize()
    time.sleep(WINDOW_SETTLE_S)


class PaddedWindow:
    """A torch.profiler trace of CUDA activity from now until :meth:`stop`,
    padded with WINDOW_PADDING spin kernels on each side, and the card left
    idle for WINDOW_SETTLE_S at each end."""

    def __init__(self):
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        _settle()
        _pad()

    def stop(self) -> None:
        _pad()
        _settle()
        self.prof.stop()

    def count(self, name: str) -> WindowCount:
        """:func:`count_in_window` over the stopped trace's device events."""
        dev = sorted((e for e in self.prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        return count_in_window([e.name for e in dev], name)


def kernels_in_window(fn, name: str) -> WindowCount:
    """The kernels whose name holds ``name`` that the card runs during
    ``fn()``, a replayed graph's included (:class:`PaddedWindow`)."""
    window = PaddedWindow()
    try:
        fn()
    finally:
        window.stop()
    return window.count(name)
