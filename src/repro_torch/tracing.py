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
"""

from __future__ import annotations

import functools
import threading
import time
from contextlib import nullcontext
from typing import NamedTuple

from torch.profiler import record_function

PREFIX = "repro."

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
