"""The port's dry-run on fake meshes against the reference's arithmetic.

The cells of the reference's ``TestTinyMeshDryrun`` (whose own tests fail
on jax 0.9, ROADMAP.md queue 3) run through ``launch.dryrun.run_cell``
on the ``tiny`` (2, 2) mesh with the same ``cfg_overrides``, and granite
``train_4k`` on ``tiny_multi`` (2, 2, 2): 4 or 8 fake ranks in this
process, traced as rank 0 on ``meta`` tensors. Each record must give a
positive analytic step and fit 16 GiB; its ``per_chip_argument_bytes``
must equal the bytes of the reference's own input shardings for the
cell (its ``param_shardings`` and logical-axis specs resolved on an
``AbstractMesh``, so no device is needed), and its analytic ``roofline``
the reference's ``costmodel.cell_cost(...).to_json()`` exactly. The
arguments' local tensors are ``meta`` (nothing allocated), and no process
group outlives a cell. This file holds the train cells; the serving
cells are in ``tests/test_torch_dryrun_serve.py``.
"""

import dataclasses
import math

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.configs.shapes import SHAPES as JSHAPES
from repro.configs.shapes import input_specs as jinput_specs
from repro.core import costmodel as jcostmodel
from repro.models import transformer as JT
from repro.optim import AdamWConfig as JAdamWConfig
from repro.parallel import sharding as jsh
from repro.train import loop as JLoop
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as lm
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.dtensor_tools import fake_world

#: the reference test's cfg_overrides: the smoke config's widths
SMALL_KEYS = ('num_layers', 'd_model', 'd_ff', 'vocab_size', 'num_heads',
              'num_kv_heads', 'head_dim', 'num_experts', 'top_k',
              'd_ff_expert', 'kv_lora_rank', 'qk_nope_dim', 'qk_rope_dim',
              'v_head_dim', 'ssm_state', 'ssm_head_dim', 'ssm_chunk',
              'frontend_dim', 'num_patches', 'num_shared_experts')
MULTI_OVER = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=256,
                  num_heads=4, num_kv_heads=2, head_dim=16)


def small(arch: str) -> dict:
    return {k: v for k, v in vars(configs.get_smoke_config(arch)).items()
            if k in SMALL_KEYS}


def _mesh_of(mesh_name: str):
    spec = dryrun.MESHES[mesh_name]
    return tuple(spec["shape"]), tuple(spec["axes"])


def _shard_bytes(shape, dtype, spec, ctx) -> int:
    n = 1
    for d, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        n *= d // ctx.axis_size(names) if names else d
    return n * jax.numpy.dtype(dtype).itemsize


def reference_arg_bytes(arch, shape_name, mesh_name, over, *,
                        unstacked: bool = True) -> tuple[int, bool]:
    """Per-chip bytes of the reference's ``prepare_cell`` arguments for
    the cell: its shardings, resolved on an ``AbstractMesh``; and whether
    its FSDP pick sharded a stacked leaf over its leading "layers" axis.

    The reference stacks each block parameter over the layers
    (``units/b{i}/<name>``, leading axis "layers", rule None), so its
    FSDP pick may land on that axis where it is the largest free one (a
    norm or bias whose other axis is on "model"). The port's per-layer
    parameters have no such axis. ``unstacked`` applies the reference's
    own ``param_shardings`` to each layer's slice instead, as the port's
    leaves are laid out; the two totals differ only where that pick
    landed on the layers axis."""
    cfg = dataclasses.replace(jconfigs.get_config(arch),
                              attention_impl="chunked", **over)
    shape = JSHAPES[shape_name]
    rules = {"cache_seq": ("data",)} if shape_name == "long_500k" else None
    ctx = jsh.ShardingCtx(AbstractMesh(*_mesh_of(mesh_name)), rules)
    key = jax.random.key(0)

    on_layers = []

    def params_bytes(tree):
        axes = JT.param_logical_axes(tree)
        total = 0
        for leaf, ax in zip(jax.tree.leaves(tree), jax.tree.leaves(
                axes, is_leaf=lambda x: isinstance(x, tuple))):
            spec = jsh.param_shardings(ax, leaf, ctx).spec
            stacked = ax[:1] == ("layers",)
            on_layers.append(stacked and spec[0] is not None)
            if unstacked and stacked:
                one = jax.ShapeDtypeStruct(leaf.shape[1:], leaf.dtype)
                spec = jsh.param_shardings(ax[1:], one, ctx).spec
                total += leaf.shape[0] * _shard_bytes(one.shape, one.dtype,
                                                      spec, ctx)
            else:
                total += _shard_bytes(leaf.shape, leaf.dtype, spec, ctx)
        return total

    def by_axes(tree, axes):
        return sum(_shard_bytes(leaf.shape, leaf.dtype,
                                ctx.spec(ax, leaf.shape), ctx)
                   for leaf, ax in zip(jax.tree.leaves(tree), jax.tree.leaves(
                       axes, is_leaf=lambda x: isinstance(x, tuple))))

    batch_axes = lambda specs: {k: ("batch",) + (None,) * (v.ndim - 1)
                                for k, v in specs.items()}
    if shape.kind == "train":
        st = jax.eval_shape(lambda k: JLoop.init_state(
            cfg, JAdamWConfig(moment_dtype="bfloat16"), k), key)
        specs = jinput_specs(cfg, shape)
        return (params_bytes(st.params) + params_bytes(st.opt_state["m"])
                + params_bytes(st.opt_state["v"])
                + st.opt_state["count"].dtype.itemsize
                + st.step.dtype.itemsize + by_axes(specs, batch_axes(specs)),
                any(on_layers))
    params = jax.eval_shape(lambda k: JT.init_params(cfg, k), key)
    if shape.kind == "prefill":
        specs = jinput_specs(cfg, shape)
        return (params_bytes(params) + by_axes(specs, batch_axes(specs)),
                any(on_layers))
    b = shape.global_batch
    cache = jax.eval_shape(lambda: JT.init_cache(cfg, b, shape.seq_len))
    return (params_bytes(params) + by_axes(cache, JT.cache_logical_axes(cache))
            + _shard_bytes((b, 1), "int32", ctx.spec(("batch", None),
                                                      (b, 1)), ctx) + 4,
            any(on_layers))


def reference_roofline(arch, shape_name, mesh_name, over) -> dict:
    cfg = dataclasses.replace(jconfigs.get_config(arch),
                              attention_impl="chunked", **over)
    sizes = dict(zip(*reversed(_mesh_of(mesh_name))))
    plan = jcostmodel.ParallelismPlan(
        dp=sizes.get("pod", 1) * sizes.get("data", 1),
        tp=sizes.get("model", 1), remat=cfg.remat,
        kv_cache_bytes=1 if cfg.kv_cache_dtype == "int8" else 2)
    return jcostmodel.cell_cost(cfg, JSHAPES[shape_name], plan).to_json()


def run_cells(cells, tmp_path_factory) -> dict:
    out = tmp_path_factory.mktemp("dryrun")
    recs = {}
    for cell, (arch, shape, mesh, over) in cells.items():
        assert not dist.is_initialized()
        recs[cell] = dryrun.run_cell(arch, shape, mesh, str(out / mesh),
                                     cfg_overrides=over)
        assert not dist.is_initialized(), "the fake group outlived a cell"
    return recs


def check_gates(rec, cell):
    assert rec["roofline"]["step_s"] > 0
    assert rec["memory"]["fits_16gb"], rec["memory"]
    assert rec["chips"] == math.prod(_mesh_of(cell[2])[0])
    assert rec["compile_s"] == 0.0 and rec["lower_s"] > 0
    rc = rec["roofline_compiled"]
    assert rc["hlo_flops"] > 0 and rc["hlo_bytes"] > 0
    assert set(rc["coll_payload"]) <= {"all-gather", "all-reduce",
                                       "reduce-scatter", "all-to-all",
                                       "collective-permute"}
    # FSDP parameters are gathered before use on every cell
    assert rc["coll_payload"].get("all-gather", 0) > 0


def check_arg_bytes(rec, cell):
    """Equal to the reference's, leaf for leaf as the port's per-layer
    leaves lie; and equal to its stacked total unless its FSDP pick put
    a stacked leaf's shard on the layers axis."""
    arch, shape, mesh, over = cell
    got = rec["memory"]["per_chip_argument_bytes"]
    want, _ = reference_arg_bytes(arch, shape, mesh, over)
    stacked, on_layers = reference_arg_bytes(arch, shape, mesh, over,
                                             unstacked=False)
    assert got == want
    assert got == stacked or on_layers


def check_roofline(rec, cell):
    arch, shape, mesh, over = cell
    assert rec["roofline"] == reference_roofline(arch, shape, mesh, over)


def check_meta(rec, cell):
    """The cell's arguments hold meta local tensors: nothing allocated."""
    arch, shape, mesh_name, over = cell
    with fake_world(rec["chips"]):
        mesh = lm.make_production_mesh(**dryrun.MESHES[mesh_name], fake=True)
        _, args, _ = dryrun.prepare_cell(arch, shape, mesh,
                                         cfg_overrides=over)
        leaves = dryrun.tensor_leaves(args)
        assert leaves and all(sh.is_dtensor(t) or t.ndim == 0
                              for t in leaves)
        assert all((t.to_local() if sh.is_dtensor(t) else t).is_meta
                   for t in leaves)
    assert not dist.is_initialized()


CHECKS = {"gates": check_gates, "arg_bytes": check_arg_bytes,
          "roofline": check_roofline, "meta": check_meta}

CELLS = {
    "granite-8b-train_4k": ("granite-8b", "train_4k", "tiny",
                            small("granite-8b")),
    "phi3.5-moe-42b-a6.6b-train_4k": ("phi3.5-moe-42b-a6.6b", "train_4k",
                                      "tiny", small("phi3.5-moe-42b-a6.6b")),
    "hubert-xlarge-train_4k": ("hubert-xlarge", "train_4k", "tiny",
                               small("hubert-xlarge")),
    "granite-8b-train_4k-tiny_multi": ("granite-8b", "train_4k",
                                       "tiny_multi", MULTI_OVER),
}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    return run_cells(CELLS, tmp_path_factory)


@pytest.mark.parametrize("check", sorted(CHECKS))
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_train_cell(records, cell, check):
    CHECKS[check](records[cell], CELLS[cell])


def test_multi_pod_axis_shards(records):
    """The 3-axis (pod, data, model) mesh traces with the pod axis in the
    sharding: 8 chips, data parallelism over pod x data in the plan."""
    rec = records["granite-8b-train_4k-tiny_multi"]
    assert rec["chips"] == rec["roofline_compiled"]["chips"] == 8
    assert rec["roofline_compiled"]["coll_payload"]


def test_cli_traces_a_cell_and_skips_what_the_reference_skips(
        tmp_path, capsys):
    dryrun.main(["--arch", "mamba2-1.3b", "--shape", "long_500k",
                 "--mesh", "tiny", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.startswith("OK   mamba2-1.3b × long_500k [tiny] trace=")
    assert "1/1 cells traced on mesh 'tiny'" in out
    assert (tmp_path / "tiny" / "mamba2-1.3b__long_500k.json").exists()
    dryrun.main(["--arch", "granite-8b", "--shape", "long_500k",
                 "--mesh", "tiny", "--out", str(tmp_path)])
    assert capsys.readouterr().out.startswith("SKIP granite-8b × long_500k")
    assert dryrun.build_parser().get_default("out") == \
        "build/repro_torch/dryrun"
    assert not dist.is_initialized()


def test_fake_world_refuses_a_standing_group():
    """A real group made after the fake ones (this module's cells ran
    first) works, and no fake group can stand beside it."""
    lm.ensure_world("cpu")
    try:
        t = torch.ones(3)
        dist.all_reduce(t)
        assert dist.get_backend() == "gloo" and torch.equal(t, torch.ones(3))
        with pytest.raises(RuntimeError, match="already exists"):
            with fake_world(4):
                pass
    finally:
        lm.release_world()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="fake_world"):
        lm.make_production_mesh(shape=(2, 2), fake=True)


def test_meshes_are_the_references():
    # the reference's table (importing its module would set XLA_FLAGS
    # for this process's jax)
    assert dryrun.MESHES == {
        "single": dict(multi_pod=False),
        "multi": dict(multi_pod=True),
        "tiny": dict(shape=(2, 2), axes=("data", "model")),
        "tiny_multi": dict(shape=(2, 2, 2), axes=("pod", "data", "model")),
    }
    assert [dryrun.mesh_chips(m) for m in dryrun.MESHES] == [256, 512, 4, 8]
