"""The port's spans and counters (``repro_torch.tracing``) on smoke
configs, on the CPU: off they are one shared no-op and record nothing;
on they change no served token and no trained parameter, nest under
``engine.step`` with their parents and request ids, and the paged
engine's ``kv.live`` and ``kv.gathered`` counters equal hand counts over
a scripted run of admissions, prefill chunks, decodes and a preemption.
The kernel witness's count over a padded window's device events is
whole only where padding is left at both ends."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, tracing
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serve.engine import PagedServeEngine, Request
from repro_torch.train.loop import init_state, make_train_step

ARCHS = ("granite-8b", "deepseek-v2-lite-16b")


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and nothing kept."""
    tracing.enable(False)
    tracing.drain()
    yield
    tracing.enable(False)
    tracing.drain()


def _model(arch):
    cfg = configs.get_smoke_config(arch)
    if cfg.is_moe:
        # the absorbed MLA the benchmark serves; capacity for every row
        cfg = dataclasses.replace(cfg, mla_absorbed=True,
                                  capacity_factor=float(cfg.num_experts))
    return cfg, T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _requests(cfg, n=4):
    rng = np.random.default_rng(3)
    return [Request(uid, rng.integers(1, cfg.vocab_size, size=int(plen))
                    .astype(np.int32), int(new))
            for uid, (plen, new) in enumerate(
                zip(rng.integers(3, 14, n), rng.integers(2, 6, n)))]


def _serve(cfg, params, on):
    tracing.enable(on)
    eng = PagedServeEngine(cfg, params, max_slots=2, max_len=32,
                           prefill_chunk=8, page_len=4)
    reqs = _requests(cfg)
    for r in reqs:
        eng.submit(r)
    done = eng.run_to_completion()
    tracing.enable(False)
    return {r.uid: list(r.generated) for r in done}, reqs, tracing.drain()


def test_off_is_one_shared_no_op_and_keeps_nothing():
    assert not tracing.enabled()
    a, b = tracing.span("engine.step"), tracing.span("attn.core", uid=3)
    assert a is b
    with a, b:
        tracing.count("kv.live", 5)
    assert tracing.drain() == {"spans": [], "counters": {}}


def test_on_records_nesting_counts_and_drains():
    tracing.enable(True)
    assert tracing.enabled()

    @tracing.spanned("inner")
    def inner():
        tracing.count("n", 2)

    with tracing.span("outer", uid=7):
        inner()
        inner()
    tracing.count("n", 1)
    got = tracing.drain()
    assert [(s.name, s.parent, s.uid) for s in got["spans"]] == [
        ("outer", None, 7), ("inner", 0, None), ("inner", 0, None)]
    assert all(s.start_ns <= s.end_ns for s in got["spans"])
    assert got["spans"][0].start_ns <= got["spans"][1].start_ns
    assert got["spans"][2].end_ns <= got["spans"][0].end_ns
    assert got["counters"] == {"n": 5}
    assert tracing.drain() == {"spans": [], "counters": {}}


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_serves_the_same_tokens_traced(arch):
    cfg, params = _model(arch)
    off, _, kept = _serve(cfg, params, False)
    on, _, got = _serve(cfg, params, True)
    assert kept == {"spans": [], "counters": {}}
    assert on == off
    assert got["spans"] and got["counters"]["kv.gathered"] > 0
    # a CPU engine runs every decode tick eagerly (no CUDA graph): each
    # one counts, and nothing counts a capture or a replay
    spans = got["spans"]
    decodes = sum(s.name == "engine.upload"
                  and spans[s.parent].name == "engine.decode" for s in spans)
    assert got["counters"]["engine.decode_eager"] == decodes > 0
    assert not {"engine.decode_graphed", "engine.graph_captures"} \
        & set(got["counters"])


@pytest.mark.parametrize("arch", ARCHS)
def test_spans_nest_under_engine_step_with_parents_and_uids(arch):
    cfg, params = _model(arch)
    _, reqs, got = _serve(cfg, params, True)
    spans = got["spans"]
    names = {s.name for s in spans}
    want = {"engine.step", "engine.prefill", "engine.decode",
            "engine.upload", "engine.sync", "attn.kv_write", "attn.kv_read",
            "attn.core"}
    if cfg.is_moe:
        want |= {"moe.route", "moe.experts", "moe.combine"}
    assert names == want

    def chain(i):
        out = []
        while spans[i].parent is not None:
            i = spans[i].parent
            out.append(spans[i].name)
        return out

    for i, s in enumerate(spans):
        up = chain(i)
        if s.name == "engine.step":
            assert up == []
            continue
        assert up[-1] == "engine.step", (s.name, up)
        assert spans[s.parent].start_ns <= s.start_ns <= s.end_ns \
            <= spans[s.parent].end_ns
        if s.name in ("engine.prefill", "engine.decode"):
            assert up == ["engine.step"]
        elif s.name in ("engine.upload", "engine.sync"):
            assert up[0] in ("engine.prefill", "engine.decode")
        else:                       # the model's layers run inside _step
            assert up[-2] in ("engine.prefill", "engine.decode")
    prefills = [s for s in spans if s.name == "engine.prefill"]
    assert {s.uid for s in prefills} == {r.uid for r in reqs}
    assert all(s.uid is None for s in spans if s.name != "engine.prefill")
    # every prefill chunk of a request carries its uid; a chunk of P
    # prompt tokens at 8 a chunk
    for r in reqs:
        assert sum(s.uid == r.uid for s in prefills) == -(-len(r.prompt) // 8)


def test_request_clock_stamps_survive_preemption():
    cfg, params = _model("granite-8b")
    eng = PagedServeEngine(cfg, params, max_slots=2, max_len=16,
                           prefill_chunk=4, page_len=4, num_pages=4)
    a = Request(0, np.arange(1, 6, dtype=np.int32), 4)
    b = Request(1, np.arange(1, 4, dtype=np.int32), 6)
    for r in (a, b):
        eng.submit(r)
        assert r.submitted_at is not None and r.admitted_at is None
    eng.step()
    stamped = (b.submitted_at, b.admitted_at)
    assert a.submitted_at <= a.admitted_at <= b.admitted_at
    eng.run_to_completion()
    assert eng.preemptions == 1
    assert (b.submitted_at, b.admitted_at) == stamped


def test_kv_counters_equal_hand_counts_through_a_preemption():
    """Two slots, pages of 4, chunks of 4, a 16-token row of 4 pages, and
    a pool of 3 pages. A (5 + 4 tokens) and B (3 + 6) are admitted in
    step 1. A prefills in two chunks (steps 1-2), B in one (step 3); in
    step 4 B cannot grow to a second page and rolls itself back, A
    finishes; B is admitted again in step 5 and decodes to its end. A
    prefill chunk gathers one row (16 positions) and its live count is
    its prefill frontier; a decode tick reads each decoding row up to its
    own position (the paged decode attention), so it counts position + 1
    a row on both counters, and nothing for the row on the scratch
    page."""
    cfg, params = _model("granite-8b")
    eng = PagedServeEngine(cfg, params, max_slots=2, max_len=16,
                           prefill_chunk=4, page_len=4, num_pages=4)
    assert eng.pages_per_seq * eng.page_len == 16
    eng.submit(Request(0, np.arange(1, 6, dtype=np.int32), 4))
    eng.submit(Request(1, np.arange(1, 4, dtype=np.int32), 6))
    tracing.enable(True)
    live, gathered = [], []
    while eng.waiting or eng.prefilling or eng.active:
        eng.step()
        c = tracing.drain()["counters"]
        live.append(c.get("kv.live", 0))
        gathered.append(c.get("kv.gathered", 0))
    assert eng.preemptions == 1
    #        A 0-4   A 4-5 +  B 0-3 +   A 8   B 0-3 +  B 5 .. 8
    #                A 6      A 7, B 4         B 4
    assert live == [4, 5 + 6, 3 + 7 + 4, 8, 3 + 4, 5, 6, 7, 8]
    assert gathered == [16, 16 + 6, 16 + 7 + 4, 8, 16 + 4, 5, 6, 7, 8]


def test_train_step_gives_the_same_loss_and_parameters_traced():
    cfg = configs.get_smoke_config("granite-8b")
    opt = AdamWConfig(lr=1e-3)
    step = make_train_step(cfg, opt, in_place=True)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    out = {}
    for on in (False, True):
        state = init_state(cfg, opt, torch.Generator().manual_seed(0), "cpu")
        tracing.enable(on)
        state, metrics = step(state, batch)
        tracing.enable(False)
        out[on] = (float(metrics["loss"]), state.named(), tracing.drain())
    assert out[True][0] == out[False][0]
    for k, p in out[False][1].items():
        assert torch.equal(p, out[True][1][k]), k
    assert out[False][2] == {"spans": [], "counters": {}}
    spans = out[True][2]["spans"]
    assert [s.name for s in spans if s.parent is None] == [
        "train.forward", "train.backward", "optim.adamw"]
    assert {s.name for s in spans} >= {"attn.core"}


SPIN = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
KERNEL = "paged_decode_split"


@pytest.mark.parametrize("names,kernels,whole", [
    # padding left at both ends: every event of the window's own is there
    ([SPIN] * 3 + [KERNEL, "combine", KERNEL, "gemm"] + [SPIN] * 2, 2, True),
    # the trace lost the leading spins and a kernel after them
    (["combine", KERNEL, "gemm"] + [SPIN] * 4, 1, False),
    # and at the end
    ([SPIN] * 4 + [KERNEL, "gemm", KERNEL], 2, False),
    # the window ran nothing of its own
    ([SPIN] * 6, 0, False),
    ([], 0, False)])
def test_window_count_is_whole_only_with_padding_at_both_ends(
        names, kernels, whole):
    got = tracing.count_in_window(names, KERNEL)
    assert got.kernels == kernels and got.whole is whole
    if whole:
        assert (got.before, got.after) == (3, 2)
