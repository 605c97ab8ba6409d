"""The paged engine's decode tick as a CUDA graph (``serve/engine.py``,
``decode_graph_applies`` and ``_DecodeGraph``).

On the CPU: the predicate is false on a ``DTensor`` pool under a 1-rank
gloo mesh, whose engine counts every decode tick eager and nothing as a
graph, and the graph's key reads every parameter of every architecture.
(``tests/test_torch_tracing.py`` holds a CPU engine's counters.)

On the card (``gpu``): the graphed engine serves the same tokens, and
hands its sampler the same logits, bit for bit, as a twin engine whose
ticks run the engine's private eager step, over admissions, finishes,
page growth across page edges and a preemption in a tight pool, on
granite-, deepseek- and jamba-shaped smoke configs (jamba's SSM rows are
slot-resident); only live rows are compared (an idle row's attention is
zeros on the kernel's path). The graph is captured again after a new
pool and after new weights, and not after ``reset_paging`` alone. The
card runs the paged decode kernel once a layer on every decode tick, as
a padded torch.profiler trace counts it (``tracing.kernels_in_window``),
while Python calls its wrapper only at the capture tick; a replayed tick
records ``engine.replay`` and no layer span or counter.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, tracing
from repro_torch.kernels import paged_decode as pd
from repro_torch.launch import mesh as lm
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as sh
from repro_torch.serve import engine as E
from repro_torch.serve.engine import PagedServeEngine, Request

ARCHS = ("granite-8b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b")
#: (tick, prompt length, new tokens): two requests at once, then
#: admissions while others decode; pages of 4, so every row crosses page
#: edges as it grows
SCHEDULE = [(0, 5, 9), (0, 3, 12), (2, 9, 6), (3, 2, 10), (6, 13, 5),
            (9, 4, 8), (14, 7, 7)]
GEOMETRY = dict(max_slots=3, max_len=32, page_len=4, prefill_chunk=8)


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.enable(False)
    tracing.drain()
    yield
    tracing.enable(False)
    tracing.drain()


def _model(arch, device="cpu", seed=0):
    cfg = configs.get_smoke_config(arch)
    if cfg.is_moe:
        # the absorbed MLA the benchmark serves; capacity for every row,
        # so idle rows compete for no expert slot
        cfg = dataclasses.replace(cfg, mla_absorbed=True,
                                  capacity_factor=float(cfg.num_experts))
    return cfg, T.init_params(cfg, torch.Generator(device=device)
                              .manual_seed(seed), device)


def _requests(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [(tick, Request(uid, rng.integers(1, cfg.vocab_size, size=plen)
                           .astype(np.int32), new))
            for uid, (tick, plen, new) in enumerate(SCHEDULE)]


def _watch(eng, seen: list):
    """A sampler that keeps a copy of each decode tick's live rows."""
    def sampler(logits):
        if logits.dim() == 2:
            seen.append({s: logits[s].clone() for s in sorted(eng.active)})
        return torch.argmax(logits, -1)
    return sampler


def _drive(eng, cfg, seed=0, max_ticks=200):
    """Run the schedule; the tokens by uid and each decode tick's live
    logits by slot."""
    seen: list = []
    eng.sampler = _watch(eng, seen)
    todo = _requests(cfg, seed)
    tick = 0
    while todo or eng.waiting or eng.prefilling or eng.active:
        while todo and todo[0][0] <= tick:
            eng.submit(todo.pop(0)[1])
        eng.step()
        eng.check_invariants()
        tick += 1
        assert tick < max_ticks
    return {r.uid: list(r.generated) for r in eng.finished}, seen


def _eager_twin(eng):
    """``eng`` with every tick on the engine's eager step."""
    eng._step = eng._eager_step
    return eng


def _decode_ticks(spans) -> int:
    """Decode ticks that ran a model step: ``engine.upload`` spans right
    under ``engine.decode``."""
    return sum(s.name == "engine.upload"
               and spans[s.parent].name == "engine.decode" for s in spans)


# -- on the CPU -----------------------------------------------------------------


def _mesh_rank() -> dict:
    """On one gloo rank: a granite smoke engine with its pool on a
    1-device mesh."""
    cfg, params = _model("granite-8b")
    mesh = lm.make_serve_mesh(1, device_type="cpu")
    eng = PagedServeEngine(cfg, params, mesh=mesh, **GEOMETRY)
    tracing.enable(True)
    tokens, _ = _drive(eng, cfg)
    tracing.enable(False)
    got = tracing.drain()
    return {"dtensor": sh.is_dtensor(eng.cache["k"]),
            "applies": E.decode_graph_applies(eng),
            "graph": eng._graph is not None,
            "tokens": tokens, "counters": got["counters"],
            "decode_ticks": _decode_ticks(got["spans"])}


def test_mesh_engine_on_a_dtensor_pool_ticks_eagerly():
    out, = lm.run_ranks(_mesh_rank, 1)
    assert out["dtensor"] and not out["applies"] and not out["graph"]
    c = out["counters"]
    assert c["engine.decode_eager"] == out["decode_ticks"] > 0
    assert "engine.decode_graphed" not in c
    assert "engine.graph_captures" not in c
    cfg, params = _model("granite-8b")
    plain, _ = _drive(PagedServeEngine(cfg, params, **GEOMETRY), cfg)
    assert out["tokens"] == plain


@pytest.mark.parametrize("arch", configs.list_archs())
def test_the_graph_key_reads_every_parameter(arch):
    """A parameter the key missed would keep a graph over weights that
    are gone."""
    cfg = configs.get_smoke_config(arch)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    got = E._param_leaves(params)
    assert len(got) == len({id(t) for t in got})
    assert {id(t) for t in got} == {id(t) for t in params.parameters()}


# -- on the card ----------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch sees no CUDA device)")


def _equal_live(a: list, b: list) -> None:
    assert len(a) == len(b)
    for tick, (x, y) in enumerate(zip(a, b)):
        assert x.keys() == y.keys(), tick
        for slot in x:
            assert torch.equal(x[slot], y[slot]), (tick, slot)


def _tight(cfg, params, **kw):
    """A pool of 8 pages (and the scratch page) where the schedule's peak
    wants 11: it must preempt."""
    return PagedServeEngine(cfg, params, num_pages=9, **GEOMETRY, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_graphed_tokens_and_logits_equal_the_eager_twin_on_card(arch):
    _card()
    cfg, params = _model(arch, "cuda")
    eng = _tight(cfg, params)
    twin = _eager_twin(_tight(cfg, params))
    assert E.decode_graph_applies(eng)
    tracing.enable(True)
    got, seen = _drive(eng, cfg)
    tracing.enable(False)
    c = tracing.drain()["counters"]
    want, twin_seen = _drive(twin, cfg)
    assert got == want and len(got) == len(SCHEDULE)
    _equal_live(seen, twin_seen)
    assert eng.preemptions == twin.preemptions > 0
    assert eng.stats() == twin.stats()
    assert c["engine.graph_captures"] == 1
    assert c["engine.decode_graphed"] > c["engine.decode_eager"] == 1
    assert c["engine.decode_graphed"] + 1 == len(seen)


@pytest.mark.gpu
def test_a_custom_sampler_sees_the_eager_logits_on_card():
    """A sampler of its own (top-k sampling from a seeded generator) is
    handed the graph's logits buffer; its draws, and the logits, equal
    the eager twin's."""
    _card()
    cfg, params = _model("granite-8b", "cuda")

    def drive(eng):
        gen = torch.Generator(device="cuda").manual_seed(7)
        seen = []

        def sampler(logits):
            if logits.dim() == 2:
                seen.append({s: logits[s].clone() for s in sorted(eng.active)})
            top = torch.topk(logits, 4, dim=-1)
            pick = torch.multinomial(torch.softmax(top.values, -1), 1,
                                     generator=gen)
            return top.indices.gather(-1, pick).squeeze(-1)
        eng.sampler = sampler
        for _, r in _requests(cfg, seed=1):
            eng.submit(r)
        eng.run_to_completion()
        return {r.uid: list(r.generated) for r in eng.finished}, seen

    got, seen = drive(PagedServeEngine(cfg, params, **GEOMETRY))
    want, twin_seen = drive(_eager_twin(
        PagedServeEngine(cfg, params, **GEOMETRY)))
    assert got == want
    _equal_live(seen, twin_seen)


@pytest.mark.gpu
def test_new_pools_and_new_weights_capture_again_on_card():
    _card()
    cfg, params = _model("granite-8b", "cuda")
    _, other = _model("granite-8b", "cuda", seed=1)
    eng = PagedServeEngine(cfg, params, **GEOMETRY)
    twin = _eager_twin(PagedServeEngine(cfg, params, **GEOMETRY))
    tracing.enable(True)
    captures = []

    def run(e):
        out = _drive(e, cfg)
        e.finished.clear()
        if e is eng:
            captures.append(tracing.drain()["counters"]
                            .get("engine.graph_captures", 0))
        return out

    def both(change):
        change(eng)
        change(twin)
        got, seen = run(eng)
        want, twin_seen = run(twin)
        assert got == want
        _equal_live(seen, twin_seen)

    both(lambda e: None)
    # the same pool after reset_paging: the graph stays
    both(lambda e: e.reset_paging())
    pool = dict(eng.cache)

    def new_pool(e):
        e.reset_paging()
        e.cache = T.init_paged_cache(cfg, e.alloc.num_pages, e.page_len,
                                     e.max_slots, device="cuda")
    both(new_pool)
    both(lambda e: setattr(e, "params", other))
    tracing.enable(False)
    assert captures == [1, 0, 1, 1]
    assert all(pool[n].data_ptr() != t.data_ptr()
               for n, t in eng.cache.items())


@pytest.mark.gpu
def test_every_decode_tick_runs_the_kernel_on_card_and_a_replay_only_replays():
    _card()
    cfg, params = _model("granite-8b", "cuda")
    eng = PagedServeEngine(cfg, params, **GEOMETRY)
    eng.submit(_requests(cfg)[1][1])           # 3 prompt tokens, 12 new
    tracing.enable(True)
    ticks = []
    for _ in range(4):
        tracing.drain()
        pd.reset_launches()
        seen = tracing.kernels_in_window(eng.step, "paged_decode_split")
        assert seen.whole, seen
        ticks.append((seen.kernels, pd.launches, tracing.drain()))
    tracing.enable(False)
    # every tick decodes: the card runs the kernel once a layer each time,
    # and Python calls the wrapper at the capture tick only (its warm-up
    # and the capture)
    assert [t[0] for t in ticks] == [cfg.num_layers] * 4
    assert [t[1] for t in ticks] == [2 * cfg.num_layers, 0, 0, 0]
    capture, replay = ticks[0][2], ticks[3][2]
    c = capture["counters"]
    assert c["engine.decode_eager"] == c["engine.graph_captures"] == 1
    assert c["attn.paged_decode"] == cfg.num_layers      # the warm-up's
    assert "attn.core" in [s.name for s in capture["spans"]]
    c = replay["counters"]
    assert c["engine.decode_graphed"] == 1
    assert not {"engine.decode_eager", "engine.graph_captures",
                "attn.paged_decode"} & set(c)
    spans = replay["spans"]
    assert [s.name for s in spans] == [
        "engine.step", "engine.decode", "engine.upload", "engine.replay",
        "engine.sync"]
    assert spans[3].parent == 1


@pytest.mark.gpu
def test_a_pool_on_a_mesh_ticks_eagerly_on_card():
    _card()
    cfg, params = _model("granite-8b", "cuda")
    assert E.decode_graph_applies(PagedServeEngine(cfg, params, **GEOMETRY))
    eng = PagedServeEngine(cfg, params, mesh=lm.make_serve_mesh(1),
                           **GEOMETRY)
    try:
        assert sh.is_dtensor(eng.cache["k"])
        assert not E.decode_graph_applies(eng)
        tokens, _ = _drive(eng, cfg)
        assert eng._graph is None and len(tokens) == len(SCHEDULE)
    finally:
        lm.release_world()
