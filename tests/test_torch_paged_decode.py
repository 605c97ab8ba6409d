"""The paged decode attention (``kernels/paged_decode.py``).

On the CPU the wrapper runs its plain version, held here to what the
paged branch computed before it: ``_paged_gather`` of both pools and the
masked plain branch of ``_sdpa``, in float32, at every (heads, KV heads,
head dim) that the port's GQA decoders serve, at the edges of a page
(positions 0, 1, 255, 256, 257 and 4,095 on pages of 256), over pages
that are not contiguous and pages that rows share, and with idle rows on
the scratch page (finite zeros). The paged engine's tokens equal the
dense engine's. The tests marked ``gpu`` hold the CUDA kernel to the
plain version on the card, count its launches on the decode path (one a
GQA layer a decode step, on the card where the engine's decode graph
replays it; none for a prefill chunk, a pool of ``DTensor``s or an MLA
layer) and check that the wrapper raises on what
the kernel does not take. No test here imports jax.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, tracing
from repro_torch.kernels import _build, ops
from repro_torch.kernels import paged_decode as pd
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve.engine import PagedServeEngine, Request, ServeEngine

#: (heads, KV heads, head dim) of every GQA decoder the paged engine
#: serves, full size and smoke size (hubert is an encoder, deepseek-v2-lite
#: attends through MLA, mamba2 has no attention)
SHAPES = sorted({(c.num_heads, c.num_kv_heads, c.head_dim)
                 for a in configs.list_archs()
                 for c in (configs.get_config(a), configs.get_smoke_config(a))
                 if c.num_heads and not (c.use_mla or c.is_encoder)})
EDGES = (0, 1, 255, 256, 257, 4095)
#: kernel against the plain version: float32 by the repo's kernel
#: tolerance (the sums run in another order); bfloat16 by its tolerance
#: and, tighter, one bfloat16 step of the value with a floor of 1e-4 (both
#: round nearly the same f32 value once; an output near 0, a sum that
#: cancels, is many steps from its neighbour for an f32 difference of 1e-6)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
BF16_STEP = dict(rtol=2 ** -7, atol=1e-4)


def _case(h, hkv, d, positions, *, page_len, pages_per_row, idle=(),
          shared=False, dtype=torch.float32, device="cpu", seed=0):
    """q, pools and tables for ``len(positions)`` rows. Each live row owns
    ``pages_per_row`` pages of a shuffled pool (page 0 the scratch page);
    ``shared`` makes every row read the first row's pages; rows in
    ``idle`` point every entry at page 0."""
    b = len(positions)
    g = torch.Generator().manual_seed(seed)
    num_pages = 1 + b * pages_per_row
    order = torch.randperm(num_pages - 1, generator=g) + 1
    table = order.reshape(b, pages_per_row)
    if shared:
        table = table[:1].expand(b, -1)
    table = table.clone()
    for r in idle:
        table[r] = 0
    pos = torch.tensor(positions, dtype=torch.long)[:, None]
    q = torch.randn((b, 1, h, d), generator=g)
    k = torch.randn((num_pages, page_len, hkv, d), generator=g)
    v = torch.randn((num_pages, page_len, hkv, d), generator=g)
    return tuple(t.to(device, dtype) for t in (q, k, v)) + (
        table.to(device), pos.to(device))


def _branch(q, k, v, table, pos):
    """What the paged branch computed before the kernel: the gather and
    the masked plain branch of ``_sdpa``."""
    cfg = configs.get_smoke_config("granite-8b")     # "ref" attention
    kg, vg = L._paged_gather(k, table), L._paged_gather(v, table)
    return L._sdpa(q, kg, vg, cfg, causal=False,
                   kv_len_mask=L._paged_valid(kg.shape[1], pos))


@pytest.mark.parametrize("h,hkv,d", SHAPES)
def test_plain_matches_the_gathered_branch_for_every_decoder(h, hkv, d):
    pos = [37, 0, 63, 64, 100]
    q, k, v, table, p = _case(h, hkv, d, pos, page_len=16, pages_per_row=8)
    got = ops.paged_decode_attention(q, k, v, table, p)
    assert got.shape == q.shape and got.dtype == q.dtype
    torch.testing.assert_close(got, _branch(q, k, v, table, p), rtol=0,
                               atol=0)


@pytest.mark.parametrize("shared", [False, True])
def test_plain_at_the_page_edges(shared):
    q, k, v, table, p = _case(4, 1, 16, EDGES, page_len=256,
                              pages_per_row=16, shared=shared)
    got = pd.paged_decode_plain(q, k, v, table, p)
    torch.testing.assert_close(got, _branch(q, k, v, table, p), rtol=0,
                               atol=0)
    # position 0 attends to its one key: the output is that key's value
    row0 = table[0, 0]
    want = v[row0, 0].repeat_interleave(4, dim=0)
    torch.testing.assert_close(got[0, 0], want, rtol=1e-6, atol=1e-6)


def test_idle_rows_are_finite_zeros():
    q, k, v, table, p = _case(8, 2, 16, [5, 300, 9, 1000], page_len=64,
                              pages_per_row=16, idle=(1, 3))
    k[0] = float("nan")                    # the scratch page holds garbage
    v[0] = float("inf")
    got = pd.paged_decode_plain(q, k, v, table, p)
    assert torch.equal(got[[1, 3]], torch.zeros_like(got[[1, 3]]))
    assert torch.isfinite(got[[0, 2]]).all()


def test_live_rows_do_not_depend_on_the_other_rows():
    q, k, v, table, p = _case(4, 2, 16, [40, 7, 90], page_len=8,
                              pages_per_row=16)
    whole = pd.paged_decode_plain(q, k, v, table, p)
    one = pd.paged_decode_plain(q[1:2], k, v, table[1:2], p[1:2])
    torch.testing.assert_close(whole[1:2], one)


def test_wrapper_checks_shapes_and_grad_on_every_device():
    q, k, v, table, p = _case(4, 2, 16, [3, 4], page_len=8, pages_per_row=2)
    with pytest.raises(ValueError, match="q must be"):
        pd.paged_decode_attention(q.expand(2, 2, 4, 16), k, v, table, p)
    with pytest.raises(ValueError, match="do not match q"):
        pd.paged_decode_attention(q, k[..., :8], v[..., :8], table, p)
    with pytest.raises(ValueError, match="do not fold"):
        pd.paged_decode_attention(q[:, :, :3], k, v, table, p)
    with pytest.raises(ValueError, match="rows"):
        pd.paged_decode_attention(q, k, v, table[:1], p)
    with pytest.raises(RuntimeError, match="no backward"):
        pd.paged_decode_attention(q.requires_grad_(), k, v, table, p)


def test_one_rule_chooses_the_kernel_for_the_layer_and_the_engine():
    """``apply_attention`` and the engine's ``kv.gathered`` ask the same
    predicate: plain pools and queries take the kernel; no GQA pool (MLA,
    no attention) does not."""
    q, k, *_ = _case(4, 2, 16, [3], page_len=8, pages_per_row=1)
    assert L.paged_decode_applies(k, q)
    assert not L.paged_decode_applies(None, q)
    cfg, params = _smoke("deepseek-v2-lite-16b")
    eng = PagedServeEngine(cfg, params, max_slots=2, max_len=32, page_len=4)
    assert not L.paged_decode_applies(eng.cache.get("k"), params.embed)


def test_split_len_is_whole_pages():
    assert [pd.split_len(n) for n in (256, 128, 5, 300, 16)] == [
        256, 256, 260, 300, 256]


def _smoke(arch="granite-8b", device="cpu"):
    cfg = configs.get_smoke_config(arch)
    return cfg, T.init_params(cfg, torch.Generator(device=device)
                              .manual_seed(0), device)


def _requests(cfg, work, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(uid, rng.integers(cfg.vocab_size, size=plen)
                    .astype(np.int32), n) for uid, (plen, n) in
            enumerate(work)]


WORK = [(8, 6), (12, 9), (5, 12), (30, 4), (3, 10), (17, 7)]


@pytest.mark.parametrize("geometry", [
    dict(max_slots=3, max_len=48, page_len=4),
    dict(max_slots=4, max_len=48, page_len=8, prefill_chunk=16)])
def test_paged_engine_tokens_equal_the_dense_engine_s(geometry):
    cfg, params = _smoke()
    out = {}
    for name, eng in (("dense", ServeEngine(cfg, params, max_slots=3,
                                            max_len=48)),
                      ("paged", PagedServeEngine(cfg, params, **geometry))):
        for r in _requests(cfg, WORK):
            eng.submit(r)
        out[name] = {r.uid: r.generated for r in eng.run_to_completion()}
    assert out["paged"] == out["dense"]
    assert len(out["paged"]) == len(WORK)


def test_decode_tick_counts_one_call_a_layer():
    """The tracing counter ``attn.paged_decode``: one a GQA layer on a
    decode tick, none on a prefill chunk."""
    cfg, params = _smoke()
    eng = PagedServeEngine(cfg, params, max_slots=2, max_len=32, page_len=4)
    eng.submit(_requests(cfg, [(3, 6)])[0])
    tracing.enable(True)
    try:
        tracing.drain()
        eng.step()                 # the prompt's one chunk and a decode tick
        first = tracing.drain()["counters"]
        eng.step()                 # a decode tick alone
        second = tracing.drain()["counters"]
    finally:
        tracing.enable(False)
    assert first["attn.paged_decode"] == cfg.num_layers
    assert second["attn.paged_decode"] == cfg.num_layers


# -- on the card -----------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch sees no CUDA device)")


def _on_card(dtype, h, hkv, d, positions, **kw):
    case = _case(h, hkv, d, positions, dtype=dtype, device="cuda", **kw)
    before = pd.launches
    got = pd.paged_decode_attention(*case)
    torch.cuda.synchronize()
    assert pd.launches == before + 1
    want = pd.paged_decode_plain(*case)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), **BF16_STEP)
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,d", SHAPES + [(16, 16, 128), (16, 1, 64)])
def test_kernel_matches_plain_on_card(dtype, h, hkv, d):
    _card()
    _on_card(dtype, h, hkv, d, [37, 0, 300, 64, 1000, 255], page_len=16,
             pages_per_row=64, idle=(3,))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("page_len", [256, 5])
def test_kernel_at_the_page_edges_on_card(dtype, shared, page_len):
    _card()
    pages = -(-4096 // page_len)
    got, _ = _on_card(dtype, 32, 8, 128, EDGES + (3000,), page_len=page_len,
                      pages_per_row=pages, shared=shared, idle=(6,))
    assert torch.equal(got[6], torch.zeros_like(got[6]))


@pytest.mark.gpu
def test_kernel_idle_rows_read_nothing_on_card():
    _card()
    case = list(_case(32, 8, 128, [5, 4000, 9, 1000], page_len=256,
                      pages_per_row=16, idle=(1, 3), dtype=torch.bfloat16,
                      device="cuda"))
    case[1][0] = float("nan")
    case[2][0] = float("nan")
    got = pd.paged_decode_attention(*case)
    torch.cuda.synchronize()
    assert torch.equal(got[[1, 3]], torch.zeros_like(got[[1, 3]]))
    assert torch.isfinite(got).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_at_the_chat_cell_s_64_rows_on_card(dtype):
    """The granite-8b.chat cell's decode shape: 64 rows of 32/8 heads of
    128 on pages of 256, 16 a row, live rows spread over all 64 with idle
    rows between; the rows past 32 take their starts from the scan's carry
    over one 32-row chunk, and the page edges stand past it too."""
    _card()
    rng = np.random.default_rng(7)
    positions = [int(p) for p in rng.integers(0, 4096, 64)]
    for row, p in zip((33, 34, 35, 36, 37, 63), (4095, 0, 255, 256, 257,
                                                  4095)):
        positions[row] = p
    idle = (0, 3, 7, 12, 20, 31, 32, 40, 45, 50, 58, 62)
    got, _ = _on_card(dtype, 32, 8, 128, positions, page_len=256,
                      pages_per_row=16, idle=idle)
    assert torch.equal(got[list(idle)], torch.zeros_like(got[list(idle)]))
    assert all(got[r].any() for r in range(64) if r not in idle)


@pytest.mark.gpu
def test_kernel_rejects_on_card():
    _card()
    q, k, v, table, p = _case(4, 2, 16, [3, 4], page_len=8, pages_per_row=2,
                              device="cuda")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pd.paged_decode_attention(q.half(), k.half(), v.half(), table, p)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pd.paged_decode_attention(q, k.bfloat16(), v, table, p)
    wide = _case(2, 1, 160, [3], page_len=8, pages_per_row=1, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        pd.paged_decode_attention(*wide)
    deep = _case(32, 1, 16, [3], page_len=8, pages_per_row=1, device="cuda")
    with pytest.raises(ValueError, match="GQA group"):
        pd.paged_decode_attention(*deep)
    with pytest.raises(ValueError, match="contiguous"):
        pd.paged_decode_attention(q, k.transpose(0, 1).contiguous()
                                  .transpose(0, 1), v, table, p)
    with pytest.raises(ValueError, match="mixed devices"):
        pd.paged_decode_attention(q, k, v, table.cpu(), p)
    # the C entry refuses what it cannot launch, and the wrapper raises
    lib = pd._library()
    out = torch.empty_like(q)
    err = _build.launch(lib.repro_paged_decode, q.device, q.data_ptr(),
                        k.data_ptr(), v.data_ptr(), table.data_ptr(),
                        p.data_ptr(), out.data_ptr(), out.data_ptr(), 2, 4,
                        2, 0, 2, 8, 256, 0, 1.0, 1)
    assert err != 0
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.check(lib, err, "paged_decode_attention")


def kernels_on_card(fn, name="paged_decode_split") -> int:
    """The kernels whose name holds ``name`` that the card runs during
    ``fn()``, from a torch.profiler trace of CUDA activity (it sees a
    replayed graph's kernels). A trace loses device events at its ends, so
    the call is padded with 1,024 spin kernels on each side, and the count
    holds only where spins are left at both ends."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(1024):
            torch.cuda._sleep(1 << 12)
        fn()
        for _ in range(1024):
            torch.cuda._sleep(1 << 12)
        torch.cuda.synchronize()
    dev = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    assert "spin_kernel" in dev[0].name and "spin_kernel" in dev[-1].name
    return sum(name in e.name for e in dev)


@pytest.mark.gpu
def test_decode_path_launches_once_a_layer_on_card():
    """A paged decode tick launches the kernel once a GQA layer; a prefill
    chunk and an MLA layer launch it 0 times."""
    _card()
    cfg, params = _smoke(device="cuda")
    cache = T.init_paged_cache(cfg, 9, 4, 2, device="cuda")
    tables = torch.tensor([[3, 1, 5, 7], [2, 6, 4, 8]], device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 8), device="cuda")
    pd.reset_launches()
    _, cache = T.paged_step(params, cfg, cache, toks,
                            torch.tensor([0, 4], device="cuda"), tables,
                            torch.arange(2, device="cuda"),
                            torch.tensor([8, 8], device="cuda"))
    assert pd.launches == 0
    logits, _ = T.paged_step(params, cfg, cache, toks[:, :1],
                             torch.tensor([8, 12], device="cuda"), tables,
                             torch.arange(2, device="cuda"))
    torch.cuda.synchronize()
    assert pd.launches == cfg.num_layers
    assert torch.isfinite(logits).all()
    mla_cfg, mla = _smoke("deepseek-v2-lite-16b", device="cuda")
    mla_cfg = dataclasses.replace(mla_cfg,
                                  capacity_factor=float(mla_cfg.num_experts))
    eng = PagedServeEngine(mla_cfg, mla, max_slots=2, max_len=32, page_len=4)
    for r in _requests(mla_cfg, [(5, 4), (9, 3)]):
        eng.submit(r)
    pd.reset_launches()
    eng.run_to_completion()
    assert pd.launches == 0 and len(eng.finished) == 2


@pytest.mark.gpu
def test_engine_on_card_launches_on_decode_ticks_only():
    _card()
    cfg, params = _smoke(device="cuda")
    eng = PagedServeEngine(cfg, params, max_slots=2, max_len=32, page_len=4)
    eng.submit(_requests(cfg, [(5, 6)])[0])
    pd.reset_launches()
    assert kernels_on_card(eng.step) == pd.launches == 0   # the prefill
    # the first decode tick: the decode graph's warm-up runs the kernel
    # once a layer, and its capture calls the wrapper once more a layer
    assert kernels_on_card(eng.step) == cfg.num_layers
    assert pd.launches == 2 * cfg.num_layers
    # a replay runs it once a layer on the card, with no call from Python
    pd.reset_launches()
    assert kernels_on_card(eng.step) == cfg.num_layers
    assert pd.launches == 0
    dense = ServeEngine(cfg, params, max_slots=2, max_len=32)
    for e in (eng, dense):
        if e is dense:
            e.submit(_requests(cfg, [(5, 6)])[0])
        e.run_to_completion()
    assert eng.finished[0].generated == dense.finished[0].generated


@pytest.mark.gpu
def test_pool_on_a_mesh_launches_nothing_on_card():
    _card()
    from repro_torch.launch import mesh as lm
    from repro_torch.parallel import sharding as sh
    cfg, params = _smoke(device="cuda")
    eng = PagedServeEngine(cfg, params, max_slots=2, max_len=32, page_len=4,
                           mesh=lm.make_serve_mesh(1))
    try:
        assert sh.is_dtensor(eng.cache["k"])
        for r in _requests(cfg, [(5, 6), (7, 4)]):
            eng.submit(r)
        pd.reset_launches()
        eng.run_to_completion()
        assert pd.launches == 0 and len(eng.finished) == 2
    finally:
        lm.release_world()
