"""Beyond-paper: mesh-sharded paged serving, the width-invariance oracle.

One fleet replica = one device slice: the paged KV pool's heads axis is
laid out over the mesh's ``"model"`` axis (``DTensor`` leaves), each rank
scatters into its own heads slice in place and the gather all-gathers
the heads back. The host-side allocator and page tables are untouched:
sharding moves the pool, never the books.

Every verdict is deterministic accounting (no timings gate anything):

* **mesh-1 oracle**: a 1-device-mesh engine equals the unsharded paged
  engine token for token on the same tick schedule;
* **width invariance**: 2/4/8-rank CPU meshes (spawned gloo ranks,
  ``launch.mesh.run_ranks``) are bit-identical to the 1-device mesh,
  including the 8-way GQA fallback;
* **zero page leaks** after drain on every width;
* **the pool is updated in place**: every pool leaf's local storage keeps
  its ``data_ptr`` across every step, on every rank (the port's reading
  of the reference's "donation honored"; its metric names are kept).

The per-shard Little's-law page pricing (thinner rows per partition)
rides along as info metrics.

The port's twin of ``benchmarks/serve_sharded.py``. The 1-device mesh
runs in this process on the run's torch device; the width sweep runs
micro4 (4 KV heads) on CPU ranks with the ``seeded_params`` weights.
"""

from __future__ import annotations

from repro_torch.bench import Context, Metric, experiment, info
from repro_torch.benchmarks.common import seeded_params as _params

#: the width sweep's workload: (prompt length, new tokens), prompts from
#: ``default_rng(3)``
WORK = ((8, 6), (12, 4), (5, 9), (16, 3))
#: the sweep's group of ranks gives up after this many seconds
SWEEP_TIMEOUT_S = 300.0


def micro_config(kv_heads: int = 2):
    """The reference's micro model (``micro4`` with 4 KV heads)."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(name="micro" if kv_heads == 2 else f"micro{kv_heads}",
                       family="dense", num_layers=2, d_model=32, d_ff=64,
                       vocab_size=64, num_heads=max(2, kv_heads),
                       num_kv_heads=kv_heads, dtype="float32",
                       param_dtype="float32")


def pool_ptrs(engine) -> dict[str, int]:
    """The ``data_ptr`` of each paged pool leaf's local storage."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel.sharding import is_dtensor
    return {name: (leaf.to_local() if is_dtensor(leaf) else leaf).data_ptr()
            for name, leaf in engine.cache.items() if name in T.PAGED_LEAVES}


def drive(engine, requests) -> dict:
    """Submit ``requests`` and step ``engine`` to drain, its books checked
    and its pool's storage compared every step. Returns tokens by uid,
    ticks, pages left allocated and whether the pool stayed in place."""
    for r in requests:
        engine.submit(r)
    ptrs = pool_ptrs(engine)
    in_place = True
    while (engine.waiting or engine.prefilling or engine.ready
           or engine.active):
        engine.step()
        engine.check_invariants()
        in_place &= pool_ptrs(engine) == ptrs
    return {"tokens": {r.uid: list(r.generated) for r in engine.finished},
            "steps": engine.steps, "leaked": engine.alloc.allocated_pages,
            "in_place": in_place, "shards": engine.shards}


def width_requests(cfg):
    import numpy as np

    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(3)
    return [Request(uid, rng.integers(cfg.vocab_size, size=plen)
                    .astype(np.int32), n)
            for uid, (plen, n) in enumerate(WORK)]


def width_rank(widths: tuple[int, ...]) -> dict:
    """One rank of the width sweep: build the 1-device mesh and each
    width's (a collective: every rank builds every mesh), and serve
    micro4 on each mesh this rank belongs to. Returns, by width, the run
    of :func:`drive` and the placements of the ``k``/``v`` leaves."""
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.serve.engine import PagedServeEngine

    cfg = micro_config(4)
    params = _params(cfg, "cpu")
    out = {}
    for w in (1,) + tuple(widths):
        mesh = make_serve_mesh(w, device_type="cpu")
        if mesh.get_coordinate() is None:
            continue
        # page_len pinned: per-shard pricing may choose other pages per
        # width, and the oracle isolates token equality from sizing
        eng = PagedServeEngine(cfg, params, max_slots=3, max_len=32,
                               page_len=8, mesh=mesh)
        run = drive(eng, width_requests(cfg))
        run["placements"] = {name: [str(p) for p in eng.cache[name].placements]
                             for name in ("k", "v")}
        out[w] = run
    return out


def width_sweep(widths: tuple[int, ...]) -> dict:
    """Serve micro4 on the 1-device mesh and at each width, on
    ``max(widths)`` spawned CPU ranks. ``equal``/``schedule``: every
    rank of every width made the 1-device mesh's tokens on its ticks;
    ``leaked``: pages left over all runs; ``in_place``: every rank's pool
    kept its storage; ``widths``: shards, ticks and the ``k``/``v``
    placements of each width."""
    from repro_torch.launch.mesh import run_ranks
    ranks = run_ranks(width_rank, max(widths), tuple(widths),
                      timeout=SWEEP_TIMEOUT_S)
    base = ranks[0][1]
    out = {"widths": {}, "equal": True, "schedule": True, "in_place": True,
           "leaked": base["leaked"], "base_steps": base["steps"],
           "base_tokens": base["tokens"]}
    for w in widths:
        runs = [r[w] for r in ranks if w in r]
        assert len(runs) == w, f"width {w} ran on {len(runs)} ranks"
        out["equal"] &= all(r["tokens"] == base["tokens"] for r in runs)
        out["schedule"] &= all(r["steps"] == base["steps"] for r in runs)
        out["in_place"] &= all(r["in_place"] for r in runs)
        out["leaked"] += sum(r["leaked"] for r in runs)
        out["widths"][w] = {"shards": runs[0]["shards"],
                            "steps": runs[0]["steps"],
                            "placements": runs[0]["placements"]}
    return out


@experiment(
    title="Mesh-sharded paged KV cache",
    section="§5.1+§6.2 applied",
    artifact="beyond-paper",
    devices=("tpu_v5e",),
    tags=("serve", "paging", "sharding", "mesh", "shard-map", "tpu"),
    expected={
        "Mesh-1 oracle": "a 1-device-mesh replica equals the unsharded "
                         "paged engine token-for-token on the same ticks",
        "Width invariance": "2/4/8-way host-device meshes are "
                            "bit-identical to the 1-device mesh",
        "Donation": "the cache updates in place on the sharded path "
                    "(buffers consumed, no XLA donation warning)",
        "Accounting": "zero pages leaked after drain on every width",
    })
def run(ctx: Context) -> list[Metric]:
    import warnings

    import numpy as np
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_serve_mesh, release_world
    from repro_torch.serve import paging
    from repro_torch.serve.engine import PagedServeEngine, Request

    cfg = micro_config()
    params = _params(cfg, ctx.torch_device)
    rng = np.random.default_rng(ctx.seed)
    n_req = 4 if ctx.quick else 6
    work = [(int(rng.integers(3, 12)), int(rng.integers(3, 9)))
            for _ in range(n_req)]

    def requests():
        rq = np.random.default_rng(ctx.seed + 1)
        return [Request(uid, rq.integers(cfg.vocab_size, size=plen)
                        .astype(np.int32), n)
                for uid, (plen, n) in enumerate(work)]

    def engine(mesh, **kw):
        geometry = dict(max_slots=3, max_len=32, page_len=8)
        geometry.update(kw)
        return PagedServeEngine(cfg, params, mesh=mesh, **geometry)

    own_group = not dist.is_initialized()
    try:
        mesh1 = make_serve_mesh(1, device_type=ctx.torch_device.type)
        oracle = drive(engine(None), requests())
        meshed = drive(engine(mesh1), requests())
        # the pool updated in place on the sharded path, and no warning
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eng = engine(mesh1, max_slots=2, page_len=4)
            eng.submit(Request(0, np.arange(4, dtype=np.int32) + 1, 12))
            before = pool_ptrs(eng)
            in_place = True
            for _ in range(6):
                eng.step()
                in_place &= pool_ptrs(eng) == before
        step_warns = [str(w.message) for w in caught]
    finally:
        if own_group:
            release_world()

    widths = (2,) if ctx.quick else (2, 4, 8)
    sweep = width_sweep(widths)
    shards_seen = {w: d["shards"] for w, d in sweep["widths"].items()}

    gen_tokens = sum(len(v) for v in oracle["tokens"].values())
    metrics = [
        Metric("mesh1_tokens_identical_to_unsharded",
               meshed["tokens"] == oracle["tokens"], True, cmp="eq",
               detail=f"{len(oracle['tokens'])} requests, {gen_tokens} "
                      f"tokens on {ctx.torch_device}"),
        Metric("mesh1_tick_schedule_matches",
               meshed["steps"] == oracle["steps"], True, cmp="eq",
               detail=f"mesh {meshed['steps']} vs unsharded "
                      f"{oracle['steps']}"),
        Metric("width_equality_bit_identical", bool(sweep["equal"]), True,
               cmp="eq",
               detail=f"widths {widths} vs 1-device mesh, spawned gloo "
                      "ranks on the CPU"),
        Metric("width_tick_schedules_match", bool(sweep["schedule"]), True,
               cmp="eq"),
        Metric("pages_leaked_all_widths",
               oracle["leaked"] + meshed["leaked"] + int(sweep["leaked"]), 0,
               cmp="eq"),
        Metric("donation_cache_consumed_in_place",
               in_place and meshed["in_place"] and sweep["in_place"], True,
               cmp="eq",
               detail="every pool leaf's local storage kept its data_ptr "
                      "across every step, on the 1-device mesh and on "
                      "every rank of every width"),
        Metric("donation_warnings", len(step_warns), 0, cmp="eq",
               detail="; ".join(step_warns) or "no warning raised while "
                                                "stepping the mesh engine"),
        info("gather_shards_by_width",
             " ".join(f"{w}->{s}" for w, s in sorted(shards_seen.items())),
             detail="8-way falls back to 1 when KV heads do not divide "
                    "(GQA replication fallback)"),
    ]
    if 8 in shards_seen:
        metrics.append(Metric("gqa_fallback_no_divergence",
                              shards_seen[8] == 1 and bool(sweep["equal"]),
                              True, cmp="eq",
                              detail="4 KV heads on an 8-way mesh "
                                     "replicate, tokens unchanged"))
    for s in (1, 2, 4, 8):
        terms = paging.page_len_rationale(cfg, expected_tokens=32, shards=s)
        best = min(terms, key=lambda t: (t.score, t.page_len))
        metrics.append(info(
            f"page_len_pricing/shards={s}",
            f"page_len={best.page_len} row_bytes={best.row_bytes} "
            f"gather_frac={best.gather_frac}",
            detail="per-partition bandwidth against 1/shards-thin rows"))
    return metrics
