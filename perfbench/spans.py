"""The program's own spans in a traced sub-window, and the readers of the
per-layer metrics they feed.

With ``repro_torch.tracing`` on, each span of the port is a
``repro.<name>`` range in the profiler's trace, on the host (and its copy
on the device's timeline, which is no device work). :func:`reduce` gives
``devtrace.reduce`` of the trace without those ranges, so every key it
has reads as it would with the program's tracing off, and adds:

- ``span_device_s``: device seconds under each span name. A device event
  is under a span when the span's host interval holds the host start of
  the runtime call that launched it (matched by correlation id), on any
  thread: ``autograd``'s own threads run the backward pass. Where the
  trace holds no such call (cuBLASLt launches its GEMMs by
  ``cuLaunchKernel``, which the profiler does not record), the start of
  the operator it is linked to stands in. It counts for the innermost
  such span and for each one around it, once a name, so
  ``engine.prefill`` holds the attention its chunk runs;
- ``span_idle_s``: the device's idle seconds under each span name, each
  gap put where its midpoint lies;
- ``span_count``: the spans of each name that began in the window;
- ``attributed_share``: the share of ``busy_s`` under some span;
- ``idle_gaps``: the gaps labelled by the innermost of the harness's
  ``pb.*`` and the program's ``repro.*`` spans together; a gap under no
  program span keeps ``devtrace``'s label.

Names in these keys are the program's own (``attn.core``); a gap's label
keeps the prefix (``repro.attn.core/aten::mm``).

:data:`READ` holds the readers of the nine per-layer metrics, by metric
name: each takes a run's records (``trace`` as :func:`reduce` gives it,
``program`` as ``repro_torch.tracing.drain`` gives it, and each request's
``submitted_at`` and ``admitted_at``), and returns None in a cell it does
not serve.
"""

from __future__ import annotations

import sys

from perfbench import devtrace, readers, stats

PREFIX = "repro."
ATTENTION = ("attn.kv_write", "attn.kv_read", "attn.core")
MOE = ("moe.route", "moe.experts", "moe.combine")
HOST_CALLS = ("cuda_runtime", "cuda_driver")


def _kind(e) -> str:
    """``devtrace``'s kind of an event, where a ``repro.`` range on a
    PyTorch without ``activity_type`` is read as a range, never as a
    kernel or an operator."""
    if (getattr(e, "activity_type", None) is None
            and e.name().startswith(PREFIX)):
        return ("gpu_user_annotation" if "CUDA" in str(e.device_type())
                else "user_annotation")
    return devtrace._kind(e)


def _linked(e) -> int | None:
    """The correlation id of the operator a device event is linked to."""
    linked = getattr(e, "linked_correlation_id", None)
    return (linked() or None) if linked is not None else None


def holders(ranges: list[tuple[float, float, str]], points: list[float]
            ) -> list[list[tuple[float, float, str]]]:
    """For each of the ascending ``points``, the ``ranges`` (start, end,
    name) that hold it, in the order they began. Ranges of several
    threads may overlap without nesting."""
    ranges = sorted(ranges)
    out, active, i = [], [], 0
    for t in points:
        while i < len(ranges) and ranges[i][0] <= t:
            active.append(ranges[i])
            i += 1
        active = [r for r in active if r[1] >= t]
        out.append(list(active))
    return out


def _innermost(held: list[tuple[float, float, str]]) -> str | None:
    """The range that began last (the shorter of two that began
    together): on one thread, the innermost."""
    if not held:
        return None
    return max(held, key=lambda r: (r[0], -r[1]))[2]


def reduce(events: list) -> dict:
    """``devtrace.reduce`` of the events but the program's ranges, with
    the keys above."""
    out = devtrace.reduce([e for e in events
                           if not e.name().startswith(PREFIX)])
    kinds = [_kind(e) for e in events]
    w0, w1 = next(devtrace._iv(e) for e, k in zip(events, kinds)
                  if k == "user_annotation" and e.name() == "pb.window")
    spans = [(*devtrace._iv(e), e.name()[len(PREFIX):])
             for e, k in zip(events, kinds)
             if k == "user_annotation" and e.name().startswith(PREFIX)]
    count: dict[str, int] = {}
    for s, _, name in spans:
        if w0 <= s <= w1:
            count[name] = count.get(name, 0) + 1

    launched = {e.correlation_id(): devtrace._iv(e)[0]
                for e, k in zip(events, kinds)
                if k in HOST_CALLS and e.correlation_id()}
    ops = {e.correlation_id(): devtrace._iv(e)[0]
           for e, k in zip(events, kinds)
           if k in ("cpu_op", "user_annotation") and e.correlation_id()}
    device = []
    for e, k in zip(events, kinds):
        if k not in devtrace.DEVICE_ACTIVITIES:
            continue
        s, t = devtrace._iv(e)
        s, t = max(s, w0), min(t, w1)
        if t > s:
            at = launched.get(e.correlation_id(), ops.get(_linked(e)))
            device.append((at, s, t))
    placed = sorted((at, s, t) for at, s, t in device if at is not None)
    under: dict[str, list] = {}
    attributed = []
    for (_, s, t), held in zip(placed,
                               holders(spans, [p[0] for p in placed])):
        if held:
            attributed.append((s, t))
        for name in {r[2] for r in held}:
            under.setdefault(name, []).append((s, t))
    span_device_s = {name: sum(t - s for s, t in devtrace._union(ivs))
                     for name, ivs in under.items()}

    busy = devtrace._union([(s, t) for _, s, t in device])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    span_idle_s: dict[str, float] = {}
    for (a, b), held in zip(idle, holders(spans, [(a + b) / 2
                                                   for a, b in idle])):
        for name in {r[2] for r in held}:
            span_idle_s[name] = span_idle_s.get(name, 0.0) + (b - a)

    long = [(a, b) for a, b in idle if b - a >= devtrace.SHORT_GAP_S]
    mids = [(a + b) / 2 for a, b in long]
    marks = [(*devtrace._iv(e), e.name()) for e, k in zip(events, kinds)
             if k == "user_annotation" and e.name() != "pb.window"
             and e.name().startswith(("pb.", PREFIX))]
    op_at = devtrace._innermost([(*devtrace._iv(e), e.name())
                                 for e, k in zip(events, kinds)
                                 if k in ("cpu_op",) + HOST_CALLS], mids)
    gaps = {"gaps under 10 us": sum(b - a for a, b in idle
                                    if b - a < devtrace.SHORT_GAP_S)}
    for (a, b), held, op in zip(long, holders(marks, mids), op_at):
        label = f"{_innermost(held) or 'pb.none'}/{op or 'no host op'}"
        gaps[label] = gaps.get(label, 0.0) + (b - a)
    gaps = {k: v for k, v in gaps.items() if v > 0}

    busy_s = out["busy_s"]
    out["idle_gaps"] = [[k, v] for k, v in sorted(
        gaps.items(), key=lambda kv: -kv[1])[:devtrace.TOP]]
    out["span_device_s"] = span_device_s
    out["span_idle_s"] = span_idle_s
    out["span_count"] = count
    out["attributed_share"] = (sum(t - s for s, t in
                                   devtrace._union(attributed)) / busy_s
                               if busy_s else 0.0)
    return out


def traced(torch, run, attempts: int = 3) -> dict:
    """:func:`reduce` of ``devtrace.capture``, tried again while blind."""
    for attempt in range(1, attempts + 1):
        try:
            return reduce(devtrace.capture(torch, run))
        except devtrace.BlindTrace as err:
            print(f"warning: traced attempt {attempt}: {err}",
                  file=sys.stderr, flush=True)
            if attempt == attempts:
                raise


# -- the readers -------------------------------------------------------------


def _trace(records: dict, key: str) -> dict | None:
    return (records.get("trace") or {}).get(key)


def device_ms_per(records: dict, names, per: str) -> float | None:
    """Device ms under the spans ``names`` over the spans ``per`` that
    began in the traced sub-window."""
    dev, n = _trace(records, "span_device_s"), _trace(records, "span_count")
    if dev is None or not (n or {}).get(per):
        return None
    return sum(dev.get(k, 0.0) for k in names) / n[per] * 1e3


def attention_ms(records: dict) -> float | None:
    """Device ms under ``attn.*`` a traced engine tick."""
    return device_ms_per(records, ATTENTION, "engine.step")


def kv_live_share(records: dict) -> float | None:
    """``kv.live`` over ``kv.gathered`` in the traced sub-window, in %."""
    c = (records.get("program") or {}).get("counters") or {}
    if not c.get("kv.gathered"):
        return None
    return c.get("kv.live", 0) / c["kv.gathered"] * 100


def prefill_chunk_ms(records: dict) -> float | None:
    """Device ms under ``engine.prefill`` a chunk."""
    return device_ms_per(records, ("engine.prefill",), "engine.prefill")


def admit_wait_ms_p95(records: dict) -> float | None:
    """95th percentile of submit to first admission on the program's own
    stamps, over the requests the run judges, in ms; one never admitted
    waited until the run stopped waiting."""
    reqs = [r for r in records.get("requests", ())
            if r.get("submitted_at") is not None]
    if not reqs:
        return None
    waited = records["waited"]
    return stats.percentile([((r["admitted_at"] if r["admitted_at"]
                               is not None else waited)
                              - r["submitted_at"]) * 1e3 for r in reqs], 95)


def host_dispatch_ms(records: dict) -> float | None:
    """Mean host ms of an ``engine.step`` span less the ``engine.sync``
    spans inside it."""
    spans = (records.get("program") or {}).get("spans")
    if not spans:
        return None
    synced: dict[int, int] = {}
    for name, start, end, parent, _ in spans:
        if name != "engine.sync" or end is None:
            continue
        while parent is not None and spans[parent][0] != "engine.step":
            parent = spans[parent][3]
        if parent is not None:
            synced[parent] = synced.get(parent, 0) + end - start
    steps = [(i, s) for i, s in enumerate(spans)
             if s[0] == "engine.step" and s[2] is not None]
    if not steps:
        return None
    return sum(s[2] - s[1] - synced.get(i, 0)
               for i, s in steps) / len(steps) * 1e-6


def moe_idle_ms(records: dict) -> float | None:
    """Device idle ms under ``moe.*`` a traced engine tick."""
    idle, n = _trace(records, "span_idle_s"), _trace(records, "span_count")
    if idle is None or not (n or {}).get("engine.step") or not any(
            n.get(k) for k in MOE):
        return None
    return sum(idle.get(k, 0.0) for k in MOE) / n["engine.step"] * 1e3


def adamw_ms(records: dict) -> float | None:
    """Device ms under ``optim.adamw`` a traced step."""
    if records.get("kind") != "train":
        return None
    return device_ms_per(records, ("optim.adamw",), "optim.adamw")


def _in(loop: str, read):
    return lambda r: read(r) if readers.serving(r, loop) else None


#: metric name -> reader
READ = {
    "attention_ms.open": _in("open", attention_ms),
    "attention_ms.closed": _in("closed", attention_ms),
    "kv_live_share.open": _in("open", kv_live_share),
    "kv_live_share.closed": _in("closed", kv_live_share),
    "prefill_chunk_ms.open": _in("open", prefill_chunk_ms),
    "admit_wait_ms_p95.open": _in("open", admit_wait_ms_p95),
    "host_dispatch_ms.closed": _in("closed", host_dispatch_ms),
    "moe_idle_ms.closed": _in("closed", moe_idle_ms),
    "adamw_ms": adamw_ms,
}
