"""Traffic is a pure function of the mix and the seed; every seed replays
the same schedule of lengths and arrivals with its own token ids; the
chat mix's medians are Splitwise's."""

import json
import statistics
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import traffic

HERE = Path(__file__).resolve().parent
CHAT = json.loads((HERE / "mixes" / "chat.json").read_text())
CLOSED = json.loads((HERE / "mixes" / "chat-closed.json").read_text())
BIG = 2 ** 31 + 12345


def _key(plan):
    return [(p.due, len(p.prompt), p.max_new, p.prompt[:4].tolist())
            for p in plan]


def _schedule(plan):
    return [(p.due, len(p.prompt), p.max_new) for p in plan]


def test_open_loop_is_a_function_of_the_seed():
    a = traffic.open_loop(CHAT, BIG, 49152, [30, 51, 60])
    b = traffic.open_loop(CHAT, BIG, 49152, [30, 51, 60])
    c = traffic.open_loop(CHAT, BIG + 1, 49152, [30, 51, 60])
    assert _key(a) == _key(b)
    assert _key(a) != _key(c)


def test_every_seed_replays_the_same_schedule():
    phases = [30, 51, 60]
    runs = [traffic.open_loop(CHAT, s, 49152, phases) for s in (1, 2, BIG)]
    assert _schedule(runs[0]) == _schedule(runs[1]) == _schedule(runs[2])
    for lo, hi in ((0, 30), (30, 81), (81, 141)):
        n = sum(lo <= p.due < hi for p in runs[0])
        assert n == round(CHAT["rate_rps"] * (hi - lo))
    dues = [p.due for p in runs[0]]
    assert dues == sorted(dues) and dues[-1] < sum(phases)


def test_chat_lengths_match_splitwise():
    rng = np.random.default_rng(0)
    prompts = traffic.gamma_lengths(rng, CHAT["prompt"], 40000)
    outputs = traffic.gamma_lengths(rng, CHAT["output"], 40000)
    assert 960 <= statistics.median(prompts) <= 1080
    assert 120 <= statistics.median(outputs) <= 138
    assert prompts.min() >= 16 and prompts.max() <= 3072
    assert outputs.min() >= 2 and outputs.max() <= 1024
    assert (prompts + outputs).max() <= 4096


def test_closed_loop_replays_the_same_lists():
    a = traffic.closed_loop(CLOSED, 5, 102400, 3)
    b = traffic.closed_loop(CLOSED, 6, 102400, 3)
    assert len(a) == CLOSED["clients"] and all(len(c) == 3 for c in a)
    lengths = lambda r: [[(len(p.prompt), p.max_new) for p in c] for c in r]
    assert lengths(a) == lengths(b)
    assert a[0][0].prompt[:8].tolist() != b[0][0].prompt[:8].tolist()
    assert traffic.client_start(CLOSED, 63) < CLOSED["start_spread_s"]


def test_train_batches_differ_by_step_and_repeat_by_seed():
    mix = {"seq_len": 16, "batch": 2}
    a = traffic.train_batch(mix, BIG, 0, 100, "cpu")
    b = traffic.train_batch(mix, BIG, 0, 100, "cpu")
    c = traffic.train_batch(mix, BIG, 1, 100, "cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert not torch.equal(a["tokens"][0], a["tokens"][1])


@pytest.mark.parametrize("seed", [0, 7, 2 ** 33])
def test_weights_repeat_by_seed(seed, tiny_configs):
    from perfbench import weights
    cfg = tiny_configs["tiny-moe"]
    a = weights.make(cfg, seed, "cpu")
    b = weights.make(cfg, seed, "cpu", groups={"layer.1"})
    assert set(b) == {k for k in a if k.startswith("blocks.1.")}
    assert all(torch.equal(a[k], b[k]) for k in b)
    assert a["blocks.0.router"].dtype == torch.float32
