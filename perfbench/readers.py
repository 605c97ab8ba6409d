"""What the per-layer metrics' readers share: each reader in
``metrics/`` is one call of these on the run's records, and returns None
where its cell has nothing for it to read."""

from __future__ import annotations

from perfbench import stats, work


def window_ticks(records: dict) -> list[dict]:
    w0, w1 = records["window"]
    return [t for t in records["ticks"] if t["start"] >= w0 and t["end"] <= w1]


def serving(records: dict, loop: str) -> bool:
    return records.get("kind") == "serve" and records.get("loop") == loop


def queue_ms_p95(records: dict) -> float | None:
    """95th percentile of due -> the end of the first tick after which the
    request held a slot, over the requests due in the window."""
    reqs = records["requests"]
    if not reqs:
        return None
    waited = records["waited"]
    return stats.percentile([((r["admit"] if r["admit"] is not None
                               else waited) - r["due"]) * 1e3
                             for r in reqs], 95)


def tick_ms(records: dict) -> float | None:
    """Host seconds of the window's engine ticks over their count, in ms."""
    ticks = window_ticks(records)
    if not ticks:
        return None
    return sum(t["end"] - t["start"] for t in ticks) / len(ticks) * 1e3


def serve_mfu(records: dict) -> float | None:
    """Useful FLOPs of the window's ticks over (their seconds x the bf16
    peak), in %."""
    ticks = window_ticks(records)
    seconds = sum(t["end"] - t["start"] for t in ticks)
    if not seconds:
        return None
    flops = sum(work.serve_tick(records["config"], t["decode_ctx"],
                                t["chunks"])[0] for t in ticks)
    return flops / (seconds * work.PEAK_FLOPS) * 100


def train_mfu(records: dict) -> float | None:
    """The window's training FLOPs over (its seconds x the bf16 peak),
    in %."""
    if records.get("kind") != "train":
        return None
    w0, w1 = records["window"]
    mix = records["mix"]
    flops, _ = work.train_step(records["config"], mix["batch"],
                               mix["seq_len"])
    return flops * records["steps"] / ((w1 - w0) * work.PEAK_FLOPS) * 100


def roofline(records: dict) -> float | None:
    """The traced sub-window's least time at the peaks (each step's
    larger of FLOPs and bytes) over the device's busy time, in %."""
    trace = records.get("trace")
    if not trace or not trace["busy_s"]:
        return None
    least = sum(work.least_seconds(f, b)[0] for f, b in trace["work"])
    return least / trace["busy_s"] * 100


def idle_share(records: dict) -> float | None:
    """1 - busy / window of the traced sub-window, in %."""
    trace = records.get("trace")
    if not trace:
        return None
    return (1 - trace["busy_s"] / trace["window_s"]) * 100
