"""The port's paged serving path against the JAX package's on the CPU.

The port's ``PagedServeEngine`` and the reference's serve the schedules
of ``tests/test_serve_paged_equiv.py`` (smoke granite-8b, weights carried
across by ``params_from_jax``, prompts made with numpy from a seed). The
two engines are stepped in lockstep: after every tick their allocator
books, page tables, positions and queues must be identical, and at the
end the greedy tokens per uid and ``stats()``. Every paged scatter the
port makes is also checked to index inside its page table: on a card an
index out of range is a device assert, where JAX would clamp or drop.
The allocator is held to the reference's case by case, and the KV
handoff (``export_pages``/``import_pages``) and ``evacuate`` give the
same requests and books. The other cache families (mamba2's
slot-resident SSM rows, deepseek-v2-lite's MLA pools, jamba's mix) run
the roomy and tight schedules in lockstep too, MoE capacity lifted.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.serve import paging as jpaging
from repro.serve.engine import PagedServeEngine as JPagedServeEngine
from repro.serve.engine import Request as JRequest
from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import cache_from_jax, params_from_jax
from repro_torch.serve import paging
from repro_torch.serve.engine import PagedServeEngine, Request

WORK = [(8, 6), (12, 4), (5, 9), (16, 3), (7, 7), (3, 5)]


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfigs.get_smoke_config("granite-8b")
    jparams = JT.init_params(jcfg, jax.random.key(0))
    cfg = configs.get_smoke_config("granite-8b")
    return jcfg, jparams, cfg, params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg)


@pytest.fixture(autouse=True)
def scatter_in_bounds(monkeypatch):
    """Every paged scatter indexes inside its table and its pool."""
    seen = []
    real = L._paged_scatter

    def checked(pages, page_table, positions, vals):
        logical = positions // pages.shape[1]
        assert int(positions.min()) >= 0
        assert int(logical.max()) < page_table.shape[1], \
            "a position indexes past its page-table row"
        assert 0 <= int(page_table.min()) and \
            int(page_table.max()) < pages.shape[0]
        seen.append(int(logical.max()))
        return real(pages, page_table, positions, vals)

    monkeypatch.setattr(L, "_paged_scatter", checked)
    return seen


def _requests(cfg, work=WORK, seed=0, cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(uid, rng.integers(cfg.vocab_size, size=plen).astype(np.int32),
                n_new) for uid, (plen, n_new) in enumerate(work)]


#: what the admission surface is asked about every tick (duck-typed: both
#: engines read only the prompt's length and max_new_tokens)
PROBE = types.SimpleNamespace(prompt=np.zeros(8, np.int32), max_new_tokens=8)


def _books(e) -> dict:
    """Everything the schedule decides, in plain Python values."""
    uids = lambda q: [r.uid for r in q]
    return {"steps": e.steps,
            "admission": (e.servable(PROBE), e.can_accept(PROBE),
                          e.saturated, e.can_import(20), e.live_count(),
                          e.live_committed_tokens()),
            "pages": {u: list(map(int, p)) for u, p in e.alloc.pages.items()},
            "free": list(map(int, e.alloc.free)),
            "owner": e.alloc.owner.tolist(),
            "page_tables": e.page_tables.tolist(),
            "positions": e.positions.tolist(),
            "last_tokens": e.last_tokens.tolist(),
            "free_slots": list(e.free_slots),
            "waiting": uids(e.waiting), "prefilling": uids(e.prefilling),
            "ready": uids(e.ready),
            "active": {s: r.uid for s, r in e.active.items()},
            "admit_seq": {r.uid: r.admit_seq for r in e._live()},
            "finished": uids(e.finished), "cancelled": uids(e.cancelled),
            "preemptions": e.preemptions, "peak_pages": e.peak_pages,
            "max_slack_tokens": e.max_slack_tokens}


def _pair(setup, **kw):
    jcfg, jparams, cfg, params = setup
    return (JPagedServeEngine(jcfg, jparams, **kw),
            PagedServeEngine(cfg, params, **kw))


def _lockstep(jeng, eng, max_ticks=500):
    """Step both engines until the reference drains, comparing the books
    after every tick; returns the port's finished requests."""
    assert _books(eng) == _books(jeng)
    for _ in range(max_ticks):
        if not (jeng.waiting or jeng.prefilling or jeng.ready or jeng.active):
            break
        jeng.step()
        eng.step()
        eng.check_invariants()
        assert _books(eng) == _books(jeng), f"books diverge at tick {eng.steps}"
    assert not (eng.waiting or eng.prefilling or eng.ready or eng.active)
    assert eng.alloc.allocated_pages == 0, "pages leaked past completion"
    got = {r.uid: r.generated for r in eng.finished}
    want = {r.uid: r.generated for r in jeng.finished}
    assert got == want
    assert eng.stats() == jeng.stats()
    assert eng.hbm_reserved_bytes() == jeng.hbm_reserved_bytes()
    assert eng.page_table_bytes() == jeng.page_table_bytes()
    return eng.finished


def _submit(setup, jeng, eng, work=WORK):
    jcfg, _, cfg, _ = setup
    for jr, r in zip(_requests(jcfg, work, cls=JRequest),
                     _requests(cfg, work)):
        jeng.submit(jr)
        eng.submit(r)


SCHEDULES = {
    # dense-equivalent capacity, cost-model-chosen page_len
    "roomy": (dict(max_slots=3, max_len=48), WORK),
    # admission gating and on-demand page growth
    "tight": (dict(max_slots=3, max_len=48, page_len=8, num_pages=8), WORK),
    # chunked prefill spanning two pages per tick
    "multi_page_chunks": (dict(max_slots=3, max_len=48, page_len=4,
                               prefill_chunk=8), WORK),
    # decode growth must evict younger requests
    "preemption": (dict(max_slots=3, max_len=32, page_len=4, num_pages=5),
                   [(2, 10)] * 3),
    # the chunk-padded frontier of a near-max_len prompt
    "padded_frontier": (dict(max_slots=2, max_len=50, page_len=5,
                             prefill_chunk=15), [(49, 1)]),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_paged_engine_matches_reference_in_lockstep(setup, name,
                                                    scatter_in_bounds):
    kw, work = SCHEDULES[name]
    jeng, eng = _pair(setup, **kw)
    _submit(setup, jeng, eng, work)
    before = fa.launches
    finished = _lockstep(jeng, eng)
    assert fa.launches == before
    assert len(finished) == len(work)
    assert scatter_in_bounds, "no paged scatter ran"
    if name == "preemption":
        assert eng.preemptions > 0, "pool was sized to force preemption"
    assert eng.max_slack_tokens <= eng.prefill_chunk


#: one arch of each cache family beside granite's GQA, as
#: tests/test_serve_paged_equiv.py: pure SSM, MLA + MoE, hybrid
FAMILIES = ("mamba2-1.3b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b")
_FAMILY_SETUPS: dict = {}


def _family_setup(arch):
    """Smoke config, MoE capacity lifted to ``num_experts`` (garbage rows
    share expert capacity; test_serve_paged_equiv.py:35-39)."""
    if arch not in _FAMILY_SETUPS:
        out = []
        for cfg in (jconfigs.get_smoke_config(arch),
                    configs.get_smoke_config(arch)):
            if cfg.is_moe:
                cfg = dataclasses.replace(
                    cfg, capacity_factor=float(cfg.num_experts))
            out.append(cfg)
        jcfg, cfg = out
        jparams = JT.init_params(jcfg, jax.random.key(0))
        _FAMILY_SETUPS[arch] = (jcfg, jparams, cfg, params_from_jax(
            jax.tree.map(np.asarray, jparams), cfg))
    return _FAMILY_SETUPS[arch]


@pytest.mark.parametrize("name", ["roomy", "tight"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_paged_engine_matches_reference_in_lockstep(arch, name):
    """The SSM's slot-resident rows, MLA's compressed pools and jamba's
    mix, stepped beside the reference's engine: books every tick, then
    tokens and stats."""
    setup = _family_setup(arch)
    kw, work = SCHEDULES[name]
    jeng, eng = _pair(setup, **kw)
    _submit(setup, jeng, eng, work)
    assert len(_lockstep(jeng, eng)) == len(work)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b"])
def test_family_handoff_carries_the_slot_resident_rows(arch):
    """export_pages/import_pages with SSM leaves: the payload's conv and
    state rows equal the reference's, and the handed-off requests decode
    to the reference's tokens."""
    setup = _family_setup(arch)
    jsrc, src = _pair(setup, max_slots=2, max_len=48, page_len=8,
                      hold_after_prefill=True)
    jdst, dst = _pair(setup, max_slots=len(WORK), max_len=48, page_len=4)
    _submit(setup, jsrc, src)
    cfg = setup[2]
    while jsrc.waiting or jsrc.prefilling or jsrc.ready:
        jsrc.step()
        src.step()
        assert _books(src) == _books(jsrc)
        for jr in list(jsrc.ready):
            jr, jpay = jsrc.export_pages(jr.uid)
            r, pay = src.export_pages(jr.uid)
            want = cache_from_jax(jpay["leaves"], cfg)
            assert set(pay["leaves"]) == set(want)
            for leaf, rows in want.items():
                np.testing.assert_allclose(
                    pay["leaves"][leaf].float().numpy(), rows.float().numpy(),
                    atol=1e-4, rtol=1e-4)
            assert dst.import_pages(r, pay) and jdst.import_pages(jr, jpay)
            assert _books(dst) == _books(jdst)
    _lockstep(jdst, dst)
    assert dst.imports == len(WORK)


def test_oldest_request_is_never_preempted(setup):
    work = [(2, 12)] * 4
    jeng, eng = _pair(setup, max_slots=3, max_len=32, page_len=4,
                      num_pages=6)
    orig = eng._preempt

    def spying_preempt(victim):
        oldest = min(r.admit_seq for r in eng._live())
        assert victim.admit_seq > oldest, \
            f"preempted uid {victim.uid} was the oldest live request"
        orig(victim)

    eng._preempt = spying_preempt
    _submit(setup, jeng, eng, work)
    _lockstep(jeng, eng)
    assert eng.preemptions > 0


def test_rejects_unservable_request(setup):
    jeng, eng = _pair(setup, max_slots=1, max_len=16, page_len=4, num_pages=3)
    for e, cls in ((jeng, JRequest), (eng, Request)):
        with pytest.raises(ValueError, match="max_len"):
            e.submit(cls(0, np.zeros(9, np.int32), 8))
        # fits max_len but can never fit the 2-page pool
        with pytest.raises(ValueError, match="pool only has 2"):
            e.submit(cls(1, np.zeros(8, np.int32), 4))
        assert not e.waiting
    with pytest.raises(ValueError, match="multiple of page_len"):
        _pair(setup, max_slots=1, max_len=16, page_len=4, prefill_chunk=6)


def test_cancel_matches_reference(setup):
    jeng, eng = _pair(setup, max_slots=3, max_len=48, page_len=8)
    _submit(setup, jeng, eng)
    for _ in range(4):
        jeng.step()
        eng.step()
    for uid in (1, 5, 42):        # decoding or prefilling, waiting, unknown
        assert eng.cancel(uid) == jeng.cancel(uid)
        assert _books(eng) == _books(jeng)
    _lockstep(jeng, eng)


def test_evacuate_then_reset_matches_reference(setup):
    jeng, eng = _pair(setup, max_slots=3, max_len=48, page_len=8)
    _submit(setup, jeng, eng)
    for _ in range(5):
        jeng.step()
        eng.step()
    assert ([r.uid for r in eng.evacuate()]
            == [r.uid for r in jeng.evacuate()])
    assert _books(eng) == _books(jeng)
    assert eng.alloc.allocated_pages == 0
    jeng.reset_paging()
    eng.reset_paging()
    assert _books(eng) == _books(jeng)
    assert eng.integrity_violations() == []
    _lockstep(jeng, eng)


def test_export_import_handoff_matches_reference(setup):
    """A prefill-holding engine hands each finished prompt to a decode
    engine of another page length; both sides' books and the payloads
    match the reference's, and the tokens match a plain run."""
    jsrc, src = _pair(setup, max_slots=2, max_len=48, page_len=8,
                      hold_after_prefill=True)
    jdst, dst = _pair(setup, max_slots=len(WORK), max_len=48, page_len=4)
    _submit(setup, jsrc, src)
    while jsrc.waiting or jsrc.prefilling or jsrc.ready:
        jsrc.step()
        src.step()
        assert _books(src) == _books(jsrc)
        for jr in list(jsrc.ready):
            jr, jpay = jsrc.export_pages(jr.uid)
            r, pay = src.export_pages(jr.uid)
            assert r.uid == jr.uid and r.generated == jr.generated
            for key in ("tokens", "pages", "page_len", "last_token"):
                assert pay[key] == jpay[key]
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    pay["leaves"][name].float().numpy(),
                    np.asarray(jpay["leaves"]["b0"][name], np.float32),
                    atol=1e-4, rtol=1e-4)
            assert _books(src) == _books(jsrc)
            assert dst.can_import(pay["tokens"]) == jdst.can_import(
                jpay["tokens"])
            assert dst.import_pages(r, pay) and jdst.import_pages(jr, jpay)
            assert _books(dst) == _books(jdst)
            dst.check_invariants()
        src.check_invariants()
    assert src.stats() == jsrc.stats() and src.exports == len(WORK)
    _lockstep(jdst, dst)
    assert dst.imports == len(WORK)


def test_mesh_is_not_ported(setup):
    _, _, cfg, params = setup
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PagedServeEngine(cfg, params, max_slots=1, max_len=16, mesh=object())


def test_paged_step_matches_reference_logits(setup):
    """One chunk, then one decode step, on the same pool and tables:
    logits within 1e-4 (float32), pools equal after each step."""
    import jax.numpy as jnp
    jcfg, jparams, cfg, params = setup
    jcache = JT.init_paged_cache(jcfg, 6, 4, 2)
    cache = T.init_paged_cache(cfg, 6, 4, 2, device="cpu")
    tables = np.array([[3, 1, 0, 0], [2, 5, 4, 0]], np.int32)
    rng = np.random.default_rng(3)
    toks = rng.integers(cfg.vocab_size, size=(2, 8)).astype(np.int32)
    start = np.array([0, 4], np.int32)
    steps = [(toks, start, np.array([8, 8], np.int32)),
             (toks[:, :1], np.array([8, 12], np.int32), None)]
    for tk, st, sl in steps:
        want, jcache = JT.paged_step(
            jparams, jcfg, jcache, jnp.asarray(tk), jnp.asarray(st),
            jnp.asarray(tables), jnp.arange(2, dtype=jnp.int32),
            None if sl is None else jnp.asarray(sl))
        got, cache = T.paged_step(
            params, cfg, cache, torch.from_numpy(tk), torch.from_numpy(st),
            torch.from_numpy(tables), torch.arange(2),
            None if sl is None else torch.from_numpy(sl))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
        for name in ("k", "v"):
            np.testing.assert_allclose(
                cache[name].numpy(), np.asarray(jcache["b0"][name]),
                atol=1e-4, rtol=1e-4)


# -- the allocator, case by case ----------------------------------------------


def test_zero_alloc_leaves_no_phantom_entry():
    for mod in (jpaging, paging):
        alloc = mod.PageAllocator(num_pages=6, page_len=4)
        assert alloc.alloc(7, 0) == []
        assert 7 not in alloc.pages, "phantom empty page-list entry"
        alloc.check_invariants()
        assert alloc.alloc(7, 2) == [1, 2]
        alloc.check_invariants()
        assert alloc.release(7) == 2
        alloc.check_invariants()


def test_invariants_reject_empty_page_list():
    for mod in (jpaging, paging):
        alloc = mod.PageAllocator(num_pages=6, page_len=4)
        alloc.pages[3] = []
        with pytest.raises(AssertionError, match="empty page list"):
            alloc.check_invariants()
        assert alloc.violations()


def test_bad_allocations_rejected():
    for mod in (jpaging, paging):
        alloc = mod.PageAllocator(num_pages=6, page_len=4)
        with pytest.raises(ValueError):
            alloc.alloc(0, -1)
        with pytest.raises(mod.OutOfPages):
            alloc.alloc(0, 6)
        with pytest.raises(ValueError):
            mod.PageAllocator(num_pages=1, page_len=4)
        with pytest.raises(ValueError):
            mod.PageAllocator(num_pages=4, page_len=0)


def test_allocator_books_match_reference_under_random_ops():
    rng = np.random.default_rng(11)
    j, t = (jpaging.PageAllocator(17, 4), paging.PageAllocator(17, 4))
    for _ in range(400):
        op, uid = rng.integers(3), int(rng.integers(6))
        if op == 0:
            n = int(rng.integers(4))
            outs = []
            for a in (j, t):
                try:
                    outs.append(a.alloc(uid, n))
                except (jpaging.OutOfPages, paging.OutOfPages) as e:
                    outs.append(str(e))
            assert outs[0] == outs[1]
        elif op == 1:
            tokens = int(rng.integers(24))
            outs = []
            for a in (j, t):
                try:
                    outs.append(a.ensure(uid, tokens))
                except (jpaging.OutOfPages, paging.OutOfPages) as e:
                    outs.append(str(e))
            assert outs[0] == outs[1]
        else:
            assert j.release(uid) == t.release(uid)
        t.check_invariants()
        assert t.pages == j.pages and list(t.free) == list(j.free)
        assert t.owner.tolist() == j.owner.tolist()
        assert (t.free_pages, t.allocated_pages) == (j.free_pages,
                                                     j.allocated_pages)
