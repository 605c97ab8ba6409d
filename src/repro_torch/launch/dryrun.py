"""Multi-pod dry-run: trace every (arch × shape × mesh) cell on fake ranks.

Twin of ``repro/launch/dryrun.py``. The reference lowers and compiles
each cell against ``ShapeDtypeStruct``s on 512 forced host devices. Here
one process stands for the whole mesh: a fake process group of as many
ranks as the mesh has chips (``parallel.dtensor_tools.fake_world``,
collectives that move nothing), and this process runs the step once as
rank 0, on ``meta`` tensors, so nothing is allocated and no card is
touched. For each supported cell it builds the production sharding
(FSDP/TP/EP/SP per ``repro_torch.parallel.sharding``: parameters by
``param_shardings``, the train state's moments beside their parameters,
inputs and caches by their logical axes) as ``DTensor``s, runs the step
under :class:`repro_torch.core.roofline.StepCounter`, and records:

  * memory — ``per_chip_argument_bytes`` from the local shard shapes,
    ``temp_per_chip_bytes`` the peak of live bytes the step allocates
    beyond its arguments, and the same 16 GiB fit test as the reference;
  * cost — flops and bytes of this rank's local ops (see
    ``core/roofline.py`` for how they differ from XLA's);
  * roofline_compiled — the three terms from those counts and the
    collective payloads the trace issued;
  * roofline — the analytic ``costmodel.cell_cost`` (authoritative, as in
    the reference).

``lower_s`` holds the trace seconds; nothing is compiled, so
``compile_s`` is 0. Every priced term is a ``tpu_v5e`` pod's (or an
installed profile's), never a measurement of the machine that traced.
Results land in ``build/repro_torch/dryrun/<mesh>/<arch>__<shape>.json``.

Usage:
  python -m repro_torch.launch.dryrun --all --mesh single
  python -m repro_torch.launch.dryrun --arch mamba2-1.3b --shape long_500k --mesh multi
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, cell_supported, input_specs
from repro_torch.core import costmodel, roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.dtensor_tools import fake_world
from repro_torch.train.loop import (TrainState, make_prefill_step,
                                    make_serve_step, make_train_step)

MESHES = {
    "single": dict(multi_pod=False),                 # 16×16 = 256 chips
    "multi": dict(multi_pod=True),                   # 2×16×16 = 512 chips
    "tiny": dict(shape=(2, 2), axes=("data", "model")),        # CI
    "tiny_multi": dict(shape=(2, 2, 2), axes=("pod", "data", "model")),
}

DEFAULT_OUT = "build/repro_torch/dryrun"


def mesh_chips(mesh_name: str) -> int:
    spec = MESHES[mesh_name]
    shape = spec.get("shape") or ((2, 16, 16) if spec.get("multi_pod")
                                  else (16, 16))
    return math.prod(shape)


def meta_dtensor(shape, dtype, sharding: sh.NamedSharding):
    """A ``DTensor`` of global ``shape`` laid out by ``sharding`` whose
    local tensor (this rank's part) is on ``meta``: shapes, no storage."""
    from torch.distributed.tensor import DTensor
    mesh, place = sharding.mesh, sharding.placements
    local = list(shape)
    for i, p in enumerate(place):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(
        torch.empty(local, dtype=dtype, device="meta"), mesh, place,
        run_check=False, shape=torch.Size(shape),
        stride=sh.contiguous_strides(shape))


def _batch_axes(batch_specs):
    axes = {}
    for name, spec in batch_specs.items():
        if spec.ndim == 0:
            axes[name] = ()
        else:
            axes[name] = ("batch",) + (None,) * (spec.ndim - 1)
    return axes


def _laid_out(tree: dict, axes: dict, ctx: sh.ShardingCtx) -> dict:
    """Meta ``DTensor``s of ``tree``'s leaves by their logical axes."""
    return {name: meta_dtensor(leaf.shape, leaf.dtype,
                               ctx.named(axes[name], leaf.shape))
            for name, leaf in tree.items()}


def _params(cfg, ctx: sh.ShardingCtx) -> T.TransformerLM:
    """``init_params`` on ``meta``, each parameter a meta ``DTensor`` laid
    out by ``param_shardings`` (with the FSDP pick)."""
    shapes = T.init_params(cfg, None, "meta")
    axes = T.param_logical_axes(shapes)
    return T.from_named(cfg, {
        name: meta_dtensor(p.shape, p.dtype,
                           sh.param_shardings(axes[name], p, ctx))
        for name, p in shapes.named_parameters()})


def tensor_leaves(obj) -> list[torch.Tensor]:
    """Every tensor of a cell's arguments: a ``TrainState``, a model,
    dicts, tuples and tensors."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, TrainState):
        return tensor_leaves((obj.params, obj.opt_state, obj.step,
                              obj.ef_state))
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters())
    if isinstance(obj, dict):
        return tensor_leaves(tuple(obj.values()))
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in tensor_leaves(o)]
    return []


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if sh.is_dtensor(t) else t


def prepare_cell(arch: str, shape_name: str, mesh, *, rules=None,
                 cfg_overrides: dict | None = None,
                 opt_overrides: dict | None = None):
    """Build (fn, example_args, cfg) for one cell: ``fn(*args)`` runs the
    step once under the cell's sharding ctx."""
    cfg = configs.get_config(arch)
    over = {"attention_impl": "chunked"}
    if cfg_overrides:
        over.update(cfg_overrides)
    cfg = dataclasses.replace(cfg, **over)
    shape = SHAPES[shape_name]
    ok, reason = cell_supported(cfg, shape)
    if not ok:
        raise ValueError(f"cell skipped: {reason}")

    cell_rules = dict(rules or {})
    if shape.name == "long_500k":
        # SP: batch-1 long context shards the cache sequence axis
        cell_rules.setdefault("cache_seq", ("data",))
    # the perf driver's rules shard some dimensions over ("model",
    # "data"): laid out in the mesh's order, the same shards per chip
    ctx = sh.ShardingCtx(mesh, cell_rules, any_order=True)

    if shape.kind == "train":
        opt = AdamWConfig(moment_dtype="bfloat16", **(opt_overrides or {}))
        params = _params(cfg, ctx).requires_grad_(True)
        named = {k: p.detach() for k, p in params.named_parameters()}
        # moments are zeros_like their parameters: laid out as they are
        state = TrainState(params, adamw_init(named, opt),
                           torch.zeros((), dtype=torch.int32, device="meta"))
        batch_specs = input_specs(cfg, shape)
        batch = _laid_out(batch_specs, _batch_axes(batch_specs), ctx)
        # in place: the twin of the reference's donate_argnums=0
        step = make_train_step(cfg, opt, in_place=True)

        def wrapped(state, batch):
            with sh.use(ctx):
                return step(state, batch)

        return wrapped, (state, batch), cfg

    # inference paths share param handling: TP + weight-sharding over the
    # data axis (per-layer all-gather); pure TP would leave jamba at 50
    # GB/chip
    params = _params(cfg, ctx)

    if shape.kind == "prefill":
        batch_specs = input_specs(cfg, shape)
        batch = _laid_out(batch_specs, _batch_axes(batch_specs), ctx)
        step = make_prefill_step(cfg, max_len=shape.seq_len)

        def wrapped(params, batch):
            with sh.use(ctx):
                return step(params, batch)

        return wrapped, (params, batch), cfg

    # decode
    b = shape.global_batch
    cache = T.init_cache(cfg, b, shape.seq_len, device="meta")
    cache = _laid_out(cache, T.cache_logical_axes(cache), ctx)
    tokens = meta_dtensor((b, 1), torch.int32, ctx.named(("batch", None),
                                                        (b, 1)))
    cache_index = torch.empty((), dtype=torch.int32, device="meta")
    step = make_serve_step(cfg)

    def wrapped(params, cache, tokens, cache_index):
        # a meta index has no value: the step is traced at the cache's
        # last position, which attends over the whole cache as every
        # position's masked attention does
        index = (shape.seq_len - 1 if cache_index.is_meta
                 else int(cache_index))
        with sh.use(ctx):
            return step(params, cache, tokens, index)

    return wrapped, (params, cache, tokens, cache_index), cfg


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: str,
             *, rules=None, cfg_overrides=None, plan_overrides=None,
             tag: str = "baseline"):
    chips = mesh_chips(mesh_name)
    with fake_world(chips):
        mesh = make_production_mesh(**MESHES[mesh_name], fake=True)
        mesh_axes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        t0 = time.time()
        fn, args, cfg = prepare_cell(arch, shape_name, mesh, rules=rules,
                                     cfg_overrides=cfg_overrides)
        leaves = tensor_leaves(args)
        counter = roofline.StepCounter(leaves)
        with counter:
            fn(*args)
        t_lower = time.time() - t0
        # analytic per-chip residency from the local shards
        arg_bytes = sum(_local(t).numel() * _local(t).element_size()
                        for t in leaves)
        del fn, args, leaves

    cost = counter.cost()
    shape = SHAPES[shape_name]
    if shape.kind == "decode":
        tokens = shape.global_batch        # one token per sequence
    else:
        tokens = shape.seq_len * shape.global_batch
    model_flops = cfg.model_flops_per_token() * tokens
    if shape.kind != "train":
        model_flops /= 3.0                  # forward only: 2·N·D

    # spec=None resolves through repro_torch.core.profile: a launcher-
    # installed dissected profile (perf.py --profile) reaches the terms
    report = roofline.analyze(
        f"{arch}__{shape_name}__{mesh_name}", cost=cost,
        collectives=counter.collectives, chips=chips, spec=None,
        model_flops=model_flops, per_device_module=True)

    # analytic roofline (authoritative, as in the reference)
    plan = costmodel.ParallelismPlan(
        dp=mesh_axes.get("pod", 1) * mesh_axes.get("data", 1),
        tp=mesh_axes.get("model", 1),
        remat=cfg.remat,
        kv_cache_bytes=1 if cfg.kv_cache_dtype == "int8" else 2)
    if plan_overrides:
        for k, v in plan_overrides.items():
            setattr(plan, k, v)
    acost = costmodel.cell_cost(cfg, shape, plan)

    # the trace is one rank's program: its sizes are already per chip
    mem_info = {"argument_size_in_bytes": arg_bytes,
                "temp_size_in_bytes": counter.peak,
                "temp_per_chip_bytes": counter.peak,
                "per_chip_argument_bytes": arg_bytes}
    per_chip_total = arg_bytes + counter.peak
    mem_info["per_chip_total_bytes"] = per_chip_total
    mem_info["fits_16gb"] = bool(per_chip_total < 16 * (1 << 30))

    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
        "chips": chips,
        "lower_s": round(t_lower, 2), "compile_s": 0.0,
        "memory": mem_info,
        "cost": cost,
        "roofline_compiled": report.to_json(),
        "roofline": acost.to_json(),
    }
    os.makedirs(out_dir, exist_ok=True)
    fname = os.path.join(out_dir, f"{arch}__{shape_name}.json"
                         if tag == "baseline"
                         else f"{arch}__{shape_name}__{tag}.json")
    with open(fname, "w") as f:
        json.dump(rec, f, indent=2)
    return rec


def build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="multi-pod dry-run: trace every (arch x shape x mesh) "
                    "cell on fake ranks, record memory/cost/collective "
                    "evidence")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=list(MESHES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--tag", default="baseline")
    return ap


def main(argv: list[str] | None = None):
    args = build_parser().parse_args(argv)

    cells = []
    archs = configs.list_archs() if (args.all or args.arch is None) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    for arch in archs:
        for shp in shapes:
            cfg = configs.get_config(arch)
            ok, reason = cell_supported(cfg, SHAPES[shp])
            if not ok:
                print(f"SKIP {arch} × {shp}: {reason}")
                continue
            cells.append((arch, shp))

    out_dir = os.path.join(args.out, args.mesh)
    failures = []
    for arch, shp in cells:
        try:
            rec = run_cell(arch, shp, args.mesh, out_dir, tag=args.tag)
            r = rec["roofline"]
            print(f"OK   {arch} × {shp} [{args.mesh}] "
                  f"trace={rec['lower_s']}s "
                  f"dom={r['dominant']} step≥{r['step_s']*1e3:.2f}ms "
                  f"roofline={r['roofline_fraction']:.1%} "
                  f"argGB/chip={rec['memory']['per_chip_argument_bytes']/2**30:.2f}")
        except Exception as e:
            failures.append((arch, shp, repr(e)))
            print(f"FAIL {arch} × {shp}: {e}")
            traceback.print_exc()
    print(f"\n{len(cells)-len(failures)}/{len(cells)} cells traced "
          f"on mesh '{args.mesh}'")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
