"""The port's parallelism against the JAX package's, in this process.

Rule resolution is pure arithmetic on axis names and sizes, so it is held
exactly to the reference on ``jax.sharding.AbstractMesh`` meshes, which
need no devices: ``ShardingCtx.spec`` and ``param_shardings`` for every
parameter of every smoke architecture on the (2,4), (4,2) and (2,2,2)
meshes, the cases of the reference's rule tests, the pool specs, the GQA
fallback and ``gather_shards``. Then what a 1-device mesh can show here:
``constrain``, ``make_serve_mesh``, and the mesh-1 oracle chain (the
port's mesh-1 engine equal to its unsharded engine, equal to the
reference's unsharded engine, on the same ticks; also over
Hypothesis-drawn schedules), the fleet and the launcher on a mesh.
Meshes of several ranks run in ``tests/test_torch_sharded_ranks.py`` and
``tests/test_torch_parallel_ranks.py``.
"""

import dataclasses
import re

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JModelConfig
from repro.parallel import sharding as jsh
from repro.serve import paging as jpaging
from repro.serve.engine import MESH_SERVE_RULES as J_MESH_SERVE_RULES
from repro.serve.engine import PagedServeEngine as JPagedServeEngine
from repro.serve.engine import Request as JRequest
from repro_torch import configs
from repro_torch.launch import mesh as lm
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.parallel import sharding as sh
from repro_torch.serve import paging
from repro_torch.serve.engine import (MESH_SERVE_RULES, PagedServeEngine,
                                      Request)
from repro_torch.serve.fleet import FleetEngine

MICRO = dict(name="micro", family="dense", num_layers=2, d_model=32,
             d_ff=64, vocab_size=64, num_heads=2, num_kv_heads=2,
             dtype="float32", param_dtype="float32")
WORK = [(8, 6), (12, 4), (5, 9), (16, 3)]
MESHES = {(2, 4): ("data", "model"), (4, 2): ("data", "model"),
          (2, 2, 2): ("pod", "data", "model")}


@pytest.fixture(autouse=True)
def no_world_left():
    """A world-1 group made by a test is gone after it, so no later test
    (on this worker) sees it."""
    yield
    lm.release_world()
    assert not torch.distributed.is_initialized()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jctx(shape, names, rules=None):
    return jsh.ShardingCtx(AbstractMesh(shape, names), rules)


def _ctx(shape, names, rules=None):
    return sh.ShardingCtx(dict(zip(names, shape)), rules)


def _entries(spec, n):
    """A reference PartitionSpec as the port's tuple of ``n`` entries."""
    out = [None if e in (None, ()) else e for e in tuple(spec)]
    return tuple(out + [None] * (n - len(out)))


# -- rule tables --------------------------------------------------------------


def test_rule_tables_are_the_references():
    assert sh.DEFAULT_RULES == jsh.DEFAULT_RULES
    assert MESH_SERVE_RULES == J_MESH_SERVE_RULES
    assert sh.DEFAULT_RULES["cache_pages"] is None
    assert MESH_SERVE_RULES["cache_kv_heads"] == "model"
    assert all(v is None for k, v in MESH_SERVE_RULES.items()
               if k != "cache_kv_heads")
    from repro.models import layers as JL
    from repro_torch.models import layers as L
    assert L.PARAM_AXES == JL.PARAM_AXES
    assert T.PAGED_CACHE_AXES == JT.PAGED_CACHE_AXES


def _ref_leaves(jcfg):
    """(port parameter name -> (reference axes, reference shape)) of a
    smoke architecture, the reference's stacked leaves of unit ``u``
    block ``b`` standing for the port's layer ``u·P + b``."""
    shapes = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.key(0)))
    axes = JT.param_logical_axes(shapes)
    flat_axes = dict(jax.tree_util.tree_flatten_with_path(
        axes, is_leaf=lambda x: isinstance(x, tuple))[0])
    flat_shapes = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
    period = len(JT.unit_spec(jcfg))
    out = {}
    for path, leaf in flat_shapes.items():
        keys = [p.key for p in path]
        if keys[0] == "units":
            block = int(keys[1][1:])
            for u in range(JT.num_units(jcfg)):
                out[f"blocks.{u * period + block}.{keys[2]}"] = (
                    flat_axes[path], leaf.shape)
        elif keys[0].startswith("frontend"):
            out[f"frontend.{keys[0]}"] = (flat_axes[path], leaf.shape)
        else:
            out[keys[0]] = (flat_axes[path], leaf.shape)
    return out


#: leaves whose reference FSDP pick lands on the stacked "layers" axis
#: (2 layers, split over "data" 2) because "model" holds their only other
#: dimension: the port's per-layer leaf keeps that entry unsharded, and
#: the rest of its spec equals the reference's
FSDP_ON_LAYERS = {"mamba2-1.3b": {((2, 4), "conv_b"), ((2, 4), "gate_norm"),
                                  ((2, 2, 2), "conv_b"),
                                  ((2, 2, 2), "gate_norm")}}


@pytest.mark.parametrize("arch", configs.list_archs())
def test_param_specs_equal_the_reference_on_every_mesh(arch):
    """``param_logical_axes``, ``ShardingCtx.spec`` and ``param_shardings``
    of every parameter, on three meshes: the reference's stacked leaf
    less its leading "layers" entry (rule None). Where the reference's
    FSDP pick lands on the stacked axis a per-layer leaf cannot follow;
    such leaves are listed (``FSDP_ON_LAYERS``)."""
    cfg = configs.get_smoke_config(arch)
    jcfg = jconfigs.get_smoke_config(arch)
    params = T.init_params(cfg, None, "meta")
    axes = T.param_logical_axes(params)
    ref = _ref_leaves(jcfg)
    assert set(axes) == set(ref)
    on_layers = []
    for shape, names in MESHES.items():
        jctx, ctx = _jctx(shape, names), _ctx(shape, names)
        shards = sh.param_shardings(axes, dict(params.named_parameters()),
                                    ctx)
        for name, (jaxes, jshape) in ref.items():
            stacked = name.startswith("blocks.")
            want_axes = jaxes[1:] if stacked else jaxes
            assert axes[name] == tuple(want_axes), name
            pshape = tuple(jshape[1:] if stacked else jshape)
            assert ctx.spec(axes[name], pshape) == _entries(
                jctx.spec(jaxes, jshape), len(jshape))[int(stacked):]
            jspec = _entries(jsh.param_shardings(
                jaxes, jax.ShapeDtypeStruct(jshape, np.float32), jctx).spec,
                len(jshape))
            if stacked and jspec[0] is not None:
                on_layers.append((shape, name.rsplit(".", 1)[-1]))
            assert shards[name].spec == jspec[int(stacked):], (shape, name)
    assert set(on_layers) == FSDP_ON_LAYERS.get(arch, set())


def test_reference_rule_cases():
    """The cases of TestShardingRules and TestRules, and the pool specs."""
    ctx = _ctx((2, 4), ("data", "model"))
    assert ctx.spec(("batch", "seq", "heads"), (8, 128, 8)) == \
        ("data", None, "model")
    assert ctx.spec(("batch", "seq", "kv_heads"), (8, 128, 3)) == \
        ("data", None, None)
    assert ctx.spec(("batch",), (8,)) == ("data",)
    ctx = _ctx((4, 2), ("data", "model"))
    shd = sh.param_shardings(("embed", "mlp"), (64, 128), ctx)
    assert shd.spec == ("data", "model")
    # a 3-axis mesh: "batch" rides (pod, data) major first, and falls back
    # to the prefix that divides
    ctx3, jctx3 = _ctx((2, 2, 2), MESHES[2, 2, 2]), _jctx((2, 2, 2),
                                                         MESHES[2, 2, 2])
    for dims in ((8, 4), (2, 4), (3, 4)):
        assert ctx3.spec(("batch", "mlp"), dims) == _entries(
            jctx3.spec(("batch", "mlp"), dims), 2)
    assert ctx3.spec(("batch", "mlp"), (8, 4)) == (("pod", "data"), "model")
    axes = ("cache_pages", None, "cache_kv_heads", "cache_head_dim")
    ctx = _ctx((4,), ("model",), MESH_SERVE_RULES)
    assert ctx.spec(axes, (16, 8, 8, 16)) == (None, None, "model", None)
    assert ctx.spec(axes, (16, 8, 3, 16)) == (None, None, None, None)
    cache = T.init_paged_cache(ModelConfig(**MICRO), 8, 4, 3, "cpu")
    assert T.paged_cache_logical_axes(cache) == {
        n: T.PAGED_CACHE_AXES[n] for n in cache}
    jctx = _jctx((4,), ("model",), J_MESH_SERVE_RULES)
    for name, shd in T.paged_cache_shardings(cache, ctx).items():
        assert shd.spec == _entries(jctx.named(
            JT.PAGED_CACHE_AXES[name], cache[name].shape).spec,
            cache[name].ndim)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = {"pod": 2, "data": 2, "model": 2}
    assert sh.placements(mesh, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.placements(mesh, (None, None)) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        sh.placements(mesh, (("data", "pod"),))


@pytest.mark.parametrize("hkv,width,want", [(4, 4, 4), (8, 4, 4), (3, 4, 1),
                                            (2, 1, 1), (4, 3, 1)])
def test_gather_shards_equal_the_reference(hkv, width, want):
    fields = dict(MICRO, num_heads=max(4, hkv), num_kv_heads=hkv)
    ctx = _ctx((width,), ("model",), MESH_SERVE_RULES)
    jctx = _jctx((width,), ("model",), J_MESH_SERVE_RULES)
    got = paging.gather_shards(ModelConfig(**fields), ctx)
    assert got == jpaging.gather_shards(JModelConfig(**fields), jctx) == want
    mla = configs.get_smoke_config("deepseek-v2-lite-16b")
    assert paging.gather_shards(mla, ctx) == 1
    assert paging.gather_shards(ModelConfig(**fields), None) == 1


# -- constrain and the meshes --------------------------------------------------


def test_constrain_is_the_identity_off_a_mesh():
    x = torch.randn(2, 3, 4)
    assert sh.current() is None
    assert sh.constrain(x, "batch", "seq", "embed") is x
    ctx = _ctx((2, 4), ("data", "model"), MESH_SERVE_RULES)
    with sh.use(ctx):
        assert sh.current() is ctx
        assert sh.constrain(x, "batch", "seq", "embed") is x
        with pytest.raises(ValueError, match="2 axes for rank-3 tensor"):
            sh.constrain(x, "batch", "seq")
    assert sh.current() is None


def test_make_serve_mesh_shapes_and_errors():
    m = lm.make_serve_mesh(device_type="cpu")
    assert m.mesh_dim_names == ("model",) and m.size() == 1
    assert lm.make_serve_mesh(1, device_type="cpu").shape == (1,)
    assert lm.make_serve_mesh((1,), device_type="cpu").shape == (1,)
    m = lm.make_serve_mesh((1, 1), device_type="cpu")
    assert m.mesh_dim_names == ("data", "model")
    m = lm.make_production_mesh(shape=(1, 1, 1), device_type="cpu")
    assert m.mesh_dim_names == ("pod", "data", "model")
    with pytest.raises(ValueError):
        lm.make_serve_mesh((0,), device_type="cpu")
    with pytest.raises(ValueError):
        lm.make_serve_mesh((1, 1, 1), device_type="cpu")
    with pytest.raises(RuntimeError, match="needs 2 devices, have 1 — "
                                           "launch 2 ranks"):
        lm.make_serve_mesh(2, device_type="cpu")
    lm.release_world()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            lm.make_serve_mesh(1)


# -- the mesh-1 oracle chain --------------------------------------------------


def _sides(arch):
    if arch == "micro":
        jcfg, cfg = JModelConfig(**MICRO), ModelConfig(**MICRO)
    else:
        jcfg = jconfigs.get_smoke_config(arch)
        cfg = configs.get_smoke_config(arch)
        if cfg.is_moe:      # capacity lifted: no drops to disagree on
            jcfg = dataclasses.replace(
                jcfg, capacity_factor=float(jcfg.num_experts))
            cfg = dataclasses.replace(
                cfg, capacity_factor=float(cfg.num_experts))
    jparams = JT.init_params(jcfg, jax.random.key(0))
    return jcfg, jparams, cfg, params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg)


def _run(engine, request_cls, vocab):
    rng = np.random.default_rng(3)
    for uid, (plen, n) in enumerate(WORK):
        engine.submit(request_cls(uid, rng.integers(vocab, size=plen)
                                  .astype(np.int32), n))
    fin = engine.run_to_completion()
    engine.check_invariants()
    assert engine.alloc.allocated_pages == 0, "pages leaked"
    return {r.uid: tuple(r.generated) for r in fin}, engine.steps


@pytest.mark.parametrize("arch", ["micro", "deepseek-v2-lite-16b"])
def test_mesh1_equals_unsharded_equals_reference(arch):
    """GQA (the sharded path at width 1) and MLA (the rank-3 fallback):
    the port's mesh-1 engine, its unsharded engine and the reference's
    unsharded engine give the same tokens on the same ticks."""
    jcfg, jparams, cfg, params = _sides(arch)
    geo = dict(max_slots=3, max_len=32, page_len=8)
    want, jsteps = _run(JPagedServeEngine(jcfg, jparams, **geo), JRequest,
                        cfg.vocab_size)
    plain = PagedServeEngine(cfg, params, **geo)
    got0, steps0 = _run(plain, Request, cfg.vocab_size)
    mesh = lm.make_serve_mesh(1, device_type="cpu")
    eng = PagedServeEngine(cfg, params, mesh=mesh, **geo)
    ptrs = {n: leaf.to_local().data_ptr() for n, leaf in eng.cache.items()
            if n in T.PAGED_LEAVES}
    got1, steps1 = _run(eng, Request, cfg.vocab_size)
    assert got0 == want and steps0 == jsteps
    assert got1 == got0 and steps1 == steps0
    assert plain.shards == eng.shards == 1
    assert eng.stats() == plain.stats()
    for name, leaf in eng.cache.items():
        if name in T.PAGED_LEAVES:
            assert sh.is_dtensor(leaf)
            assert leaf.device_mesh.mesh_dim_names == ("model",)
            assert leaf.to_local().data_ptr() == ptrs[name]
            want_place = ("S(3)" if name in ("k", "v") else "R")
            assert [str(p) for p in leaf.placements] == [want_place]
        else:
            assert not sh.is_dtensor(leaf)


def test_tiered_fleet_hands_pages_through_a_mesh_pool():
    """export_pages/import_pages move whole rows out of and into a mesh
    pool: a tiered fleet on a 1-device mesh equals the unsharded one
    (tokens, decision log, ticks), as does an N=1 fleet."""
    _, _, cfg, params = _sides("micro")
    mesh = lm.make_serve_mesh(1, device_type="cpu")

    def fleet(mesh, **kw):
        f = FleetEngine(cfg, params, max_slots=2, max_len=32, mesh=mesh,
                        **kw)
        rng = np.random.default_rng(3)
        for uid, (plen, n) in enumerate(WORK):
            f.submit(Request(uid, rng.integers(cfg.vocab_size, size=plen)
                             .astype(np.int32), n))
        f.run_to_completion()
        f.check_invariants()
        return ({r.uid: r.generated for r in f.finished()},
                f.decision_log(), f.ticks, f.stats())

    for kw in ({"replicas": 1},
               {"replicas": 2, "tiers": "prefill:0/decode:1"}):
        a, b = fleet(None, **kw), fleet(mesh, **kw)
        assert a[:3] == b[:3]
        assert b[3]["pages_leaked"] == 0
    assert b[3]["handoffs"] > 0


_MICRO_PARAMS = T.init_params(ModelConfig(**MICRO),
                              torch.Generator().manual_seed(0), "cpu")
# (prompt_len, max_new, ticks_before_submit, cancel_after_ticks|None)
JOBS = st.lists(st.tuples(st.integers(1, 12), st.integers(1, 8),
                          st.integers(0, 4), st.none() | st.integers(0, 6)),
                min_size=1, max_size=6)


def _drive(cfg, params, mesh, schedule):
    """Replay one admission/cancel schedule tick for tick, as
    ``tests/test_serve_sharded_prop.py`` replays it."""
    eng = PagedServeEngine(cfg, params, max_slots=3, max_len=24,
                           page_len=4, num_pages=14, mesh=mesh)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(cfg.vocab_size, size=plen).astype(np.int32)
               for plen, _, _, _ in schedule]
    pending = sorted(enumerate(schedule), key=lambda kv: kv[1][2])
    cancel_at: dict[int, list] = {}
    tick = 0
    while pending or eng.waiting or eng.prefilling or eng.active:
        while pending and pending[0][1][2] <= tick:
            uid, (plen, n_new, _, cancel) = pending.pop(0)
            eng.submit(Request(uid, prompts[uid], n_new))
            if cancel is not None:
                cancel_at.setdefault(tick + cancel, []).append(uid)
        for uid in cancel_at.pop(tick, ()):
            eng.cancel(uid)
        eng.step()
        eng.check_invariants()
        tick += 1
        assert tick < 500, "schedule failed to drain"
    assert eng.alloc.allocated_pages == 0, "pages leaked at drain"
    return ({r.uid: tuple(r.generated) for r in eng.finished},
            sorted(r.uid for r in eng.cancelled), tick)


@settings(max_examples=15, deadline=None)
@given(schedule=JOBS)
def test_any_schedule_mesh1_equals_unsharded(schedule):
    cfg = ModelConfig(**MICRO)
    params = _MICRO_PARAMS
    mesh = lm.make_serve_mesh(1, device_type="cpu")
    try:
        streams_u, cancelled_u, ticks_u = _drive(cfg, params, None, schedule)
        streams_m, cancelled_m, ticks_m = _drive(cfg, params, mesh, schedule)
    finally:
        lm.release_world()
    assert streams_m == streams_u and cancelled_m == cancelled_u
    assert ticks_m == ticks_u
    assert set(streams_u) | set(cancelled_u) == set(range(len(schedule)))
    assert set(streams_u).isdisjoint(cancelled_u)


# -- the launcher --------------------------------------------------------------

_MASKS = [(re.compile(r"\d[\d,]*(\.\d+)? ?(ms|s)\b"), "<t>"),
          (re.compile(r"\([\d,]+ tok/s wall\)"), "(<rate>)")]


def _mask(text):
    out = []
    for ln in text.replace(" device=cpu", "").splitlines():
        for pat, sub in _MASKS:
            ln = pat.sub(sub, ln)
        out.append(ln)
    return out


@pytest.mark.parametrize("engine", ["paged", "fleet"])
def test_launcher_on_a_mesh_prints_the_reference_lines(engine, monkeypatch,
                                                       capsys):
    jcfg = jconfigs.get_smoke_config("granite-8b")
    jparams = JT.init_params(jcfg, jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             configs.get_smoke_config("granite-8b"))
    argv = ["--arch", "granite-8b", "--smoke", "--engine", engine,
            "--mesh-shape", "1", "--requests", "4", "--max-len", "48",
            "--slots", "2"]
    jserve.main(argv)
    want = capsys.readouterr().out
    monkeypatch.setattr(serve.T, "init_params",
                        lambda cfg, gen, device: params)
    serve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert _mask(got) == _mask(want)
    assert "serve mesh: {'model': 1} (1 devices, cpu backend)" in got
    assert ("gather shards=1" if engine == "paged"
            else "gather_shards=1") in got
    with pytest.raises(SystemExit, match="needs 2 devices, have 1"):
        serve.main(["--arch", "granite-8b", "--smoke", "--engine", engine,
                    "--mesh-shape", "2", "--device", "cpu"])


# -- on the card -----------------------------------------------------------------


@pytest.mark.gpu
def test_mesh1_on_the_card_equals_the_card_s_unsharded_engine():
    """A 1-device NCCL mesh on the card: micro4's tokens and ticks equal
    the card's unsharded engine's, the pool on the mesh, in place."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from repro_torch.benchmarks import serve_sharded as ss
    cfg = ss.micro_config(4)
    params = ss._params(cfg, "cuda")
    geo = dict(max_slots=3, max_len=32, page_len=8)
    plain = ss.drive(PagedServeEngine(cfg, params, **geo),
                     ss.width_requests(cfg))
    mesh = lm.make_serve_mesh(1)
    assert torch.distributed.get_backend() != "gloo"
    eng = PagedServeEngine(cfg, params, mesh=mesh, **geo)
    meshed = ss.drive(eng, ss.width_requests(cfg))
    assert meshed["tokens"] == plain["tokens"]
    assert meshed["steps"] == plain["steps"] and meshed["in_place"]
    assert eng.cache["k"].to_local().device.type == "cuda"
