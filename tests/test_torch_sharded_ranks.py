"""Mesh-sharded paged serving on meshes of several ranks, on the CPU.

Each test spawns one group of gloo ranks (``launch.mesh.run_ranks``: a
file store in a temporary directory, the whole group bounded by a
timeout) and holds what the ranks report:

* width invariance: micro4 (4 KV heads, ``page_len`` 8, the reference's
  ``WORK``) served on 2, 3 and 4 ranks gives the 1-device mesh's tokens
  on its ticks, which are the port's unsharded engine's; ``k``/``v``
  sharded on heads at widths 2 and 4, and width 3 falling back to 1
  shard; no page leaked; every rank's pool storage kept across steps;
* the heads order of the sharded scatter and gather, bit for bit against
  the plain pool, on one axis and on two (JAX's major-first block
  order), and pages split over "data";
* page handoffs out of and into a sharded pool: the rows that
  ``export_pages`` takes and ``import_pages`` writes, bit for bit on the
  same three layouts, and a tiered fleet whose pools are sharded on 2
  ranks equal to the unsharded one;
* ``constrain`` of a ``DTensor`` and the meshes' shapes and errors.
"""

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import serve_sharded as ss
from repro_torch.launch import mesh as lm
from repro_torch.models import layers as L
from repro_torch.parallel import sharding as sh
from repro_torch.serve import engine as E
from repro_torch.serve.engine import (MESH_SERVE_RULES, PagedServeEngine,
                                      Request)
from repro_torch.serve.fleet import FleetEngine

POOL_AXES = ("cache_pages", None, "cache_kv_heads", "cache_head_dim")
#: a stacked pool leaf's axes (layers, pages, page_len, heads, head_dim)
STACKED_AXES = ("layers",) + POOL_AXES


def test_widths_2_3_4_equal_the_one_device_mesh():
    out = ss.width_sweep((2, 3, 4))
    assert out["equal"], "a width diverged from the 1-device mesh"
    assert out["schedule"], "a width changed the tick schedule"
    assert out["leaked"] == 0 and out["in_place"]
    assert {w: d["shards"] for w, d in out["widths"].items()} == {
        2: 2, 3: 1, 4: 4}
    for w, place in ((2, ["S(3)"]), (3, ["R"]), (4, ["S(3)"])):
        assert out["widths"][w]["placements"] == {"k": place, "v": place}
    cfg = ss.micro_config(4)
    plain = ss.drive(PagedServeEngine(cfg, ss._params(cfg, "cpu"),
                                      max_slots=3, max_len=32, page_len=8),
                     ss.width_requests(cfg))
    assert out["base_tokens"] == plain["tokens"]
    assert out["base_steps"] == plain["steps"]


def _pool_rank() -> dict:
    """On 4 ranks: the pool cases, ``constrain`` and the meshes."""
    out = {}
    m22 = lm.make_serve_mesh((2, 2), device_type="cpu")
    m4 = lm.make_serve_mesh(4, device_type="cpu")
    m2 = lm.make_serve_mesh(2, device_type="cpu")
    prod = lm.make_production_mesh(shape=(2, 2), device_type="cpu")
    out["meshes"] = [(m.mesh_dim_names, tuple(m.shape))
                     for m in (m22, m4, m2, prod)]
    try:
        lm.make_serve_mesh(8, device_type="cpu")
    except RuntimeError as e:
        out["short"] = str(e)

    g = torch.Generator().manual_seed(0)
    pages = torch.randn(6, 4, 8, 3, generator=g)     # (pages, len, heads, D)
    table = torch.tensor([[1, 2, 0], [3, 5, 4]])
    positions = torch.tensor([[0, 1, 4], [2, 6, 9]])
    vals = torch.randn(2, 3, 8, 3, generator=g)
    want_pool = pages.clone()
    L._paged_scatter_impl(want_pool, table, positions, vals)
    want = L._paged_gather_impl(want_pool, table)
    coord = m22.get_coordinate()
    cases = {
        "heads_on_model": (m4, {}, m4.get_coordinate()[0]),
        "heads_on_data_model": (m22, {"cache_kv_heads": ("data", "model")},
                                coord[0] * 2 + coord[1]),
        "pages_on_data": (m22, {"cache_pages": "data"}, coord[1]),
    }
    for name, (mesh, rules, block) in cases.items():
        ctx = sh.ShardingCtx(mesh, {**MESH_SERVE_RULES, **rules})
        shd = ctx.named(POOL_AXES, pages.shape)
        leaf = sh.distribute(pages, shd)
        ptr = leaf.to_local().data_ptr()
        with sh.use(ctx):
            sharded = L._paged_shard_axes(leaf) is not None
            L._paged_scatter(leaf, table, positions, vals)
            got = L._paged_gather(leaf, table)
        local = leaf.to_local()
        heads = local.shape[2]
        rows = (want_pool if name != "pages_on_data" else
                want_pool[coord[0] * 3:(coord[0] + 1) * 3])
        out[name] = {
            "spec": shd.spec, "sharded_path": sharded,
            "gather_equal": torch.equal(got, want),
            "plain_gather": not sh.is_dtensor(got),
            "pool_equal": torch.equal(leaf.full_tensor(), want_pool),
            "block_equal": torch.equal(
                local, rows[:, :, block * heads:(block + 1) * heads]),
            "in_place": leaf.to_local().data_ptr() == ptr}

        # a handoff's rows: read out whole, written back into the pool
        stacked = torch.randn(2, 6, 4, 8, 3, generator=g)
        leaf = sh.distribute(stacked, ctx.named(STACKED_AXES, stacked.shape))
        ptr = leaf.to_local().data_ptr()
        idx, rows = torch.tensor([4, 1]), torch.randn(2, 2, 4, 8, 3,
                                                      generator=g)
        got = E._pool_rows(leaf, idx)
        E._write_pool_rows(leaf, idx, rows)
        want_stacked = stacked.clone()
        want_stacked[:, idx] = rows
        out[name]["handoff"] = {
            "rows_equal": torch.equal(got, stacked[:, idx]),
            "plain_rows": not sh.is_dtensor(got),
            "written": torch.equal(leaf.full_tensor(), want_stacked),
            "in_place": leaf.to_local().data_ptr() == ptr}

    if m2.get_coordinate() is not None:
        x = torch.randn(2, 3, 4, generator=g)
        d = sh.distribute(x, sh.NamedSharding(m2, (None, None, None)))
        with sh.use(sh.ShardingCtx(m2)):
            y = sh.constrain(d, "batch", "seq", "heads")
            same = sh.constrain(x, "batch", "seq", "heads") is x
        out["constrain"] = {"placements": [str(p) for p in y.placements],
                            "values": torch.equal(y.full_tensor(), x),
                            "plain_is_same": same}
        sharded, plain = _tiered(m2), _tiered(None)
        out["tiered"] = {"equal": sharded == plain, "handoffs": sharded[3],
                         "leaked": sharded[4]}
    return out


def _tiered(mesh):
    """A tiered fleet (prefill replica 0, decode replica 1) of micro4 on
    ``mesh``, every request's pages handed from one pool to the other:
    (tokens, decision log, ticks, handoffs, leaked pages, pool placements)."""
    cfg = ss.micro_config(4)
    f = FleetEngine(cfg, ss._params(cfg, "cpu"), max_slots=2, max_len=32,
                    page_len=8, replicas=2, tiers="prefill:0/decode:1",
                    mesh=mesh)
    rng = np.random.default_rng(3)
    for uid, (plen, n) in enumerate(ss.WORK):
        f.submit(Request(uid, rng.integers(cfg.vocab_size, size=plen)
                         .astype(np.int32), n))
    f.run_to_completion()
    f.check_invariants()
    st = f.stats()
    return ({r.uid: r.generated for r in f.finished()}, f.decision_log(),
            f.ticks, st["handoffs"] > 0, st["pages_leaked"])


def test_pool_heads_order_constrain_and_meshes():
    ranks = lm.run_ranks(_pool_rank, 4)
    for rank, out in enumerate(ranks):
        assert out["meshes"] == [(("data", "model"), (2, 2)),
                                 (("model",), (4,)), (("model",), (2,)),
                                 (("data", "model"), (2, 2))]
        assert "needs 8 devices, have 4 — launch 8 ranks" in out["short"]
        assert out["heads_on_model"]["spec"] == (None, None, "model", None)
        assert out["heads_on_data_model"]["spec"] == (
            None, None, ("data", "model"), None)
        assert out["pages_on_data"]["spec"] == ("data", None, "model", None)
        for name in ("heads_on_model", "heads_on_data_model",
                     "pages_on_data"):
            case = out[name]
            assert case["sharded_path"] == (name != "pages_on_data"), name
            assert case["gather_equal"] and case["plain_gather"], name
            assert case["pool_equal"] and case["block_equal"], (rank, name)
            assert case["in_place"], name
            assert case["handoff"] == {"rows_equal": True,
                                       "plain_rows": True, "written": True,
                                       "in_place": True}, (rank, name)
        if rank < 2:
            assert out["constrain"] == {"placements": ["S(2)"],
                                        "values": True,
                                        "plain_is_same": True}
            assert out["tiered"] == {"equal": True, "handoffs": True,
                                     "leaked": 0}
        else:
            assert "constrain" not in out and "tiered" not in out


def _fail_rank():
    raise ValueError("rank fault")


def test_a_failing_rank_fails_the_group_within_its_timeout():
    with pytest.raises(RuntimeError, match="rank fault"):
        lm.run_ranks(_fail_rank, 2, timeout=60)
