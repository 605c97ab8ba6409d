"""Whole runs of tiny cells on the CPU, through the program's engine and
train step and the plain reference, past the harness's look for a card:
float32 against float32 agree to rounding, the fp8 control does not, and
each fault a cell can have turns ``correct`` false."""

import time

import pytest
import torch

from perfbench import harness, judge, manifest, serve_cell, train_cell

SEED = 2 ** 31 + 99


def _run(tiny, name, seconds=0.6):
    root, here = tiny
    cell = manifest.load_cell(name, root, here)
    return harness.run_cell(cell, SEED, seconds, False, torch.device("cpu"),
                            time.perf_counter(), {"platform": "cpu"}, here)


@pytest.mark.parametrize("name", ["tiny-dense.open", "tiny-moe.closed",
                                  "tiny-dense.train"])
def test_the_program_agrees_with_the_reference(tiny, name):
    got = _run(tiny, name)
    assert got["correct"], got["checks"]
    assert got["attempted"] > 0 and got["failed"] == 0
    assert set(got["metrics"]) >= {"setup_s"}
    assert [k for k in got if k != "_info"][-1] == "checks"


@pytest.mark.parametrize("name", ["tiny-dense.open", "tiny-moe.closed"])
def test_the_fp8_control_fails_the_serving_limit(tiny, name):
    root, here = tiny
    cell = manifest.load_cell(name, root, here)
    got = serve_cell.run(cell, SEED, 0.6, False, "cpu", time.perf_counter())
    gaps, low = judge.served_gaps(
        got["weights"], cell.config,
        *serve_cell.served(got["sample"], "cpu"), lower=("fp8",))
    assert gaps.max() <= cell.spec["limits"]["gap_max"] < low["fp8"].max()


def test_the_fp8_control_and_half_batch_fail_training(tiny):
    root, here = tiny
    cell = manifest.load_cell("tiny-dense.train", root, here)
    f32 = train_cell.reference(cell, SEED, "cpu")
    for kw in ({"prec": "fp8"}, {"half_batch": True}):
        numbers = judge.train_numbers(
            train_cell.reference(cell, SEED, "cpu", **kw), f32)
        ok, _ = judge.verdict(numbers, cell.spec["limits"])
        assert not ok, (kw, numbers)


def test_an_altered_token_fails(tiny, monkeypatch):
    build = serve_cell.build

    def altered(*a, **k):
        weights, engine = build(*a, **k)
        vocab = engine.cfg.vocab_size
        engine.sampler = lambda lg: (torch.argmax(lg, -1) + 1) % vocab
        return weights, engine

    monkeypatch.setattr(serve_cell, "build", altered)
    got = _run(tiny, "tiny-dense.open")
    assert not got["correct"] and got["checks"]["gap_max"]["value"] > 0.1


def test_a_tick_that_leaves_the_cache_unwritten_fails(tiny, monkeypatch):
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "_paged_scatter", lambda pages, *a: pages)
    got = _run(tiny, "tiny-moe.closed")
    assert not got["correct"]


def test_a_decode_that_leaves_out_half_the_batch_fails(tiny, monkeypatch):
    from repro_torch.models import transformer as T
    step = T.paged_step

    def half(params, cfg, cache, tokens, *a, **k):
        if tokens.shape[0] > 1:
            tokens = tokens.clone()
            tokens[tokens.shape[0] // 2:] = 0
        return step(params, cfg, cache, tokens, *a, **k)

    monkeypatch.setattr(T, "paged_step", half)
    got = _run(tiny, "tiny-dense.open")
    assert not got["correct"]


def test_a_step_that_leaves_the_state_unchanged_fails(tiny, monkeypatch):
    from repro_torch.train import loop as L

    def unchanged(grads, state, params, cfg, lr, *, in_place=False):
        return params, state, {"grad_norm": torch.zeros(()),
                               "clip_scale": torch.ones(())}

    monkeypatch.setattr(L, "adamw_update", unchanged)
    got = _run(tiny, "tiny-dense.train")
    assert not got["correct"]
    assert got["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_a_step_on_half_the_batch_fails(tiny, monkeypatch):
    from repro_torch.train import loop as L
    real = L.make_train_step

    def make_half(*a, **k):
        step = real(*a, **k)

        def half(state, batch):
            return step(state, {n: v[: v.shape[0] // 2]
                                for n, v in batch.items()})
        return half

    monkeypatch.setattr(L, "make_train_step", make_half)
    got = _run(tiny, "tiny-dense.train")
    assert not got["correct"], got["checks"]
