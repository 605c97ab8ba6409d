"""The program's spans in a trace: ``spans.reduce`` on hand-made kineto
events (with and without ``activity_type``), against hand sums, and the
nine readers of ``spans.READ`` on hand-built records."""

import pytest

from perfbench import devtrace, spans


class _Ev:
    """A kineto event: name, kind, start and duration in us, correlation."""

    def __init__(self, name, kind, start_us, dur_us, corr=0, linked=0):
        self._n, self._k, self._s, self._d, self._c = (name, kind, start_us,
                                                       dur_us, corr)
        self._l = linked

    def name(self):
        return self._n

    def activity_type(self):
        return self._k

    def device_type(self):
        return ("DeviceType.CUDA"
                if self._k in ("kernel", "gpu_memcpy", "gpu_user_annotation")
                else "DeviceType.CPU")

    def start_ns(self):
        return int(self._s * 1000)

    def duration_ns(self):
        return int(self._d * 1000)

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l


class _Old(_Ev):
    """The same event from a PyTorch without ``activity_type``."""
    activity_type = None


HARNESS = [("pb.window", "user_annotation", 0, 1000),
           ("pb.engine_step", "user_annotation", 0, 900),
           ("aten::mm", "cpu_op", 110, 50),
           ("cudaLaunchKernel", "cuda_runtime", 120, 5, 1),
           ("cudaLaunchKernel", "cuda_runtime", 410, 5, 2),
           ("cudaMemcpyAsync", "cuda_runtime", 700, 5, 3),
           ("cudaLaunchKernel", "cuda_runtime", 950, 5, 4),
           ("gemm", "kernel", 200, 100, 1),
           ("route", "kernel", 450, 50, 2),
           ("copy", "gpu_memcpy", 700, 100, 3),
           ("tail", "kernel", 960, 20, 4),
           ("spin", "kernel", -500, 100, 9)]
PROGRAM = [("repro.engine.step", "user_annotation", 5, 885),
           ("repro.attn.core", "user_annotation", 100, 200),
           ("repro.moe.route", "user_annotation", 400, 250),
           ("repro.engine.step", "gpu_user_annotation", 200, 600),
           ("repro.attn.core", "gpu_user_annotation", 200, 100)]


def _events(rows, cls=_Ev):
    return [cls(*r) for r in rows]


@pytest.mark.parametrize("cls", [_Ev, _Old], ids=["activity_type", "old"])
def test_program_ranges_leave_the_harness_keys_as_they_were(cls):
    plain = devtrace.reduce(_events(HARNESS, cls))
    got = spans.reduce(_events(HARNESS + PROGRAM, cls))
    for key in ("busy_s", "window_s", "device_events", "missing_launches",
                "device_ops"):
        assert got[key] == plain[key], key
    assert got["busy_s"] == pytest.approx(270e-6)
    gaps, before = dict(got["idle_gaps"]), dict(plain["idle_gaps"])
    # the one gap under no program span keeps its label and length
    assert gaps["pb.none/no host op"] == before["pb.none/no host op"] \
        == pytest.approx(20e-6)
    assert "pb.engine_step/no host op" not in gaps
    assert sum(gaps.values()) == pytest.approx(sum(before.values()))


@pytest.mark.parametrize("cls", [_Ev, _Old], ids=["activity_type", "old"])
def test_device_idle_counts_and_share_by_hand(cls):
    got = spans.reduce(_events(HARNESS + PROGRAM, cls))
    assert got["span_device_s"] == pytest.approx(
        {"engine.step": 250e-6, "attn.core": 100e-6, "moe.route": 50e-6})
    # gaps [0,200) [300,450) [500,700) [800,960) [980,1000) by midpoint
    assert got["span_idle_s"] == pytest.approx(
        {"engine.step": 710e-6, "attn.core": 200e-6, "moe.route": 200e-6})
    assert got["span_count"] == {"engine.step": 1, "attn.core": 1,
                                 "moe.route": 1}
    assert got["attributed_share"] == pytest.approx(250 / 270)
    assert dict(got["idle_gaps"]) == pytest.approx({
        "repro.attn.core/no host op": 200e-6,
        "repro.engine.step/no host op": 310e-6,
        "repro.moe.route/no host op": 200e-6,
        "pb.none/no host op": 20e-6})


def test_a_launch_on_a_second_thread_counts_under_the_backward_span():
    """The backward pass's kernels are launched from autograd's thread:
    a launch counts for every span whose interval holds it, whichever
    thread opened the span, and a recomputed forward's ``attn.core``
    (opened on that thread) is the innermost."""
    rows = [("pb.window", "user_annotation", 0, 1000),
            ("pb.train_step", "user_annotation", 0, 1000),
            ("repro.train.backward", "user_annotation", 100, 800),
            ("repro.attn.core", "user_annotation", 450, 100),
            ("cudaLaunchKernel", "cuda_runtime", 460, 2, 1),
            ("cudaLaunchKernel", "cuda_runtime", 600, 2, 2),
            ("cudaLaunchKernel", "cuda_runtime", 950, 2, 3),
            ("bmm", "kernel", 470, 100, 1),
            ("add", "kernel", 610, 40, 2),
            ("step", "kernel", 955, 10, 3)]
    got = spans.reduce(_events(rows))
    assert got["span_device_s"] == pytest.approx(
        {"train.backward": 140e-6, "attn.core": 100e-6})
    assert got["attributed_share"] == pytest.approx(140 / 150)
    # gaps [0,470) [570,610) [650,955) under the backward span, and
    # [965,1000) under the harness's alone
    assert dict(got["idle_gaps"]) == pytest.approx({
        "repro.train.backward/no host op": 815e-6,
        "pb.train_step/no host op": 35e-6})


def test_a_kernel_without_its_launch_is_placed_by_its_operator():
    """cuBLASLt launches by ``cuLaunchKernel``, which the trace does not
    hold: its kernel is placed where the operator it is linked to
    began (operators and runtime calls number their correlations
    apart)."""
    rows = [("pb.window", "user_annotation", 0, 1000),
            ("repro.moe.experts", "user_annotation", 100, 300),
            ("aten::bmm", "cpu_op", 150, 50, 7),
            ("cudaLaunchKernel", "cuda_runtime", 600, 2, 8),
            ("nvjet_gemm", "kernel", 400, 100, 7, 7),
            ("add", "kernel", 650, 50, 8, 3)]
    got = spans.reduce(_events(rows))
    assert got["span_device_s"] == pytest.approx({"moe.experts": 100e-6})
    assert got["attributed_share"] == pytest.approx(100 / 150)


def test_holders_of_overlapping_ranges():
    ranges = [(0, 10, "a"), (2, 4, "b"), (3, 12, "c")]
    got = spans.holders(ranges, [1, 3, 5, 11, 13])
    assert [[r[2] for r in h] for h in got] == [
        ["a"], ["a", "b", "c"], ["a", "c"], ["c"], []]


# -- the readers -------------------------------------------------------------

TRACE = {"busy_s": 1.0, "window_s": 2.0,
         "span_device_s": {"attn.kv_write": 0.01, "attn.kv_read": 0.02,
                           "attn.core": 0.03, "engine.prefill": 0.05,
                           "optim.adamw": 0.5},
         "span_idle_s": {"moe.route": 0.002, "moe.experts": 0.004,
                         "engine.step": 0.5},
         "span_count": {"engine.step": 2, "engine.prefill": 2,
                        "moe.route": 54, "optim.adamw": 2}}
PROGRAM_SPANS = [("engine.step", 0, 10_000_000, None, None),
                 ("engine.decode", 1_000_000, 9_000_000, 0, None),
                 ("engine.sync", 5_000_000, 8_000_000, 1, None),
                 ("engine.step", 20_000_000, 24_000_000, None, None),
                 ("engine.prefill", 20_500_000, 21_000_000, 3, 7)]
WANT = {"attention_ms.open": 30.0, "attention_ms.closed": 30.0,
        "kv_live_share.open": 25.0, "kv_live_share.closed": 25.0,
        "prefill_chunk_ms.open": 25.0, "admit_wait_ms_p95.open": 8000.0,
        "host_dispatch_ms.closed": 5.5, "moe_idle_ms.closed": 3.0,
        "adamw_ms": 250.0}


def _records(kind, loop=None):
    return {"kind": kind, "loop": loop, "waited": 10.0, "trace": TRACE,
            "program": {"spans": PROGRAM_SPANS,
                        "counters": {"kv.live": 25, "kv.gathered": 100}},
            "requests": [{"submitted_at": 1.0, "admitted_at": 1.5},
                         {"submitted_at": 2.0, "admitted_at": None}]}


CELLS = {"open": ("serve", "open"), "closed": ("serve", "closed"),
         "train": ("train", None)}


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("metric", sorted(WANT))
def test_each_reader_reads_its_cell_alone(metric, cell):
    got = spans.READ[metric](_records(*CELLS[cell]))
    serves = metric.endswith("." + cell) or (metric == "adamw_ms"
                                             and cell == "train")
    if serves:
        assert got == pytest.approx(WANT[metric])
    else:
        assert got is None


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_readers_find_nothing_in_records_without_program_tracing(cell):
    """A run whose program has no spans (the parent's, or one with the
    tracing off) gives every reader nothing to read, and none raises."""
    kind, loop = CELLS[cell]
    records = {"kind": kind, "loop": loop, "waited": 10.0,
               "trace": {"busy_s": 1.0, "window_s": 2.0},
               "requests": [{"due": 1.0, "admit": 2.0}]}
    assert {m: spans.READ[m](records) for m in WANT} == dict.fromkeys(WANT)


def test_moe_idle_needs_moe_spans():
    rec = _records("serve", "closed")
    rec["trace"] = dict(TRACE, span_count={"engine.step": 2})
    assert spans.READ["moe_idle_ms.closed"](rec) is None


# -- a tiny cell run with the program's tracing on, on the CPU ---------------


@pytest.mark.parametrize("name,want", [
    ("tiny-dense.open", {"kv_live_share.open", "admit_wait_ms_p95.open"}),
    ("tiny-moe.closed", {"kv_live_share.closed",
                         "host_dispatch_ms.closed"}),
    ("tiny-dense.train", set())])
def test_trace_program_reads_the_program_on_a_tiny_cell(tiny, name, want):
    """The sub-window runs with the program's tracing on (unprofiled on
    a CPU, so no device metric reads); the program's counters, spans and
    request stamps reach the readers, and the tracing is off after."""
    import torch

    from perfbench import manifest, trace_program
    from repro_torch import tracing
    root, here = tiny
    cell = manifest.load_cell(name, root, here)
    drive = (trace_program.train if cell.spec["driver"] == "train"
             else trace_program.serve)
    records = drive(cell, 5, 0.5, True, torch.device("cpu"), profile=False)
    assert not tracing.enabled()
    assert tracing.drain() == {"spans": [], "counters": {}}
    assert records["info"]["whole_window_spans"] > 0
    got = trace_program.summary(records)
    assert set(got["metrics"]) == want
    names = {s.name for s in records["program"]["spans"]}
    if cell.spec["driver"] == "train":
        assert {"train.forward", "train.backward", "optim.adamw"} <= names
    else:
        assert "engine.step" in names
        share = got["metrics"][f"kv_live_share.{cell.mix['loop']}"]
        assert 0 < share <= 100
