"""The model's own tensor/FSDP parallelism on several CPU ranks: forward
and one train step on ``DTensor`` parameters against the unsharded port.

Each mesh spawns one group of gloo ranks (``launch.mesh.run_ranks``,
bounded by its timeout). On every rank the smoke configs of granite-8b,
deepseek-v2-lite-16b (MLA + MoE, capacity lifted so no choice drops) and
mamba2-1.3b, in float32, get the same seeded weights, laid out by
``param_shardings`` (the FSDP pick included), and the batch by its
"batch" axis. Under the mesh's sharding ctx the ranks run
``T.forward`` and ``make_train_step``; rank 0 gathers the logits, the
gradients (``full_tensor()``) and the updated parameters. This process
computes the same with plain tensors (the unsharded port, which the
families' and training tests hold to the reference) and compares:
logits, aux and loss within 1e-5; each gradient within 1e-4 of its
leaf's largest magnitude; each updated parameter within 5e-5 wherever
its gradient stands above 1e-3 of the leaf's largest, where Adam's ratio
follows rounding noise below that (the near-zero-gradient rule of the
training tests).

This file runs the (2,) and (4,) ("model",) meshes: on 4 ranks the
smoke models' 2 KV heads do not divide the axis, so their attention takes
the GQA fallback (KV whole on every rank, each rank reading the KV head
its query heads use). The (2, 2) ("data", "model") mesh is in
``tests/test_torch_dtensor_compute_2d.py``, so that two xdist workers
share the spawned ranks.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import mesh as lm
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.parallel import sharding as sh
from repro_torch.train.loop import TrainState, loss_fn, make_train_step

ARCHS = ("granite-8b", "deepseek-v2-lite-16b", "mamba2-1.3b")
B, S = 4, 16
FWD_TOL = 1e-5
GRAD = 1e-4
QUIET = 1e-3
STEP_TOL = 5e-5
OPT = AdamWConfig(lr=1e-3)


def cfg_of(arch: str):
    cfg = configs.get_smoke_config(arch)
    over = dict(dtype="float32", param_dtype="float32")
    if cfg.is_moe:
        over["capacity_factor"] = float(cfg.num_experts)
    return dataclasses.replace(cfg, **over)


def batch_of(cfg) -> dict:
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
    return {"tokens": torch.from_numpy(tok),
            "labels": torch.from_numpy(np.roll(tok, -1, axis=1))}


def params_of(cfg) -> T.TransformerLM:
    return T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _np(t) -> np.ndarray:
    return sh.full_tensor(t).detach().numpy().copy()


def _step(params, cfg, batch):
    """(logits, aux, loss, grads, new params): the forward, the gradients
    of the train loss, and one ``make_train_step`` from zero moments."""
    with torch.no_grad():
        logits, aux = T.forward(params, cfg, {"tokens": batch["tokens"]})
    params.requires_grad_(True)
    names, leaves = zip(*params.named_parameters())
    total, metrics = loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(total, leaves)
    named = {k: p.detach() for k, p in params.named_parameters()}
    state = TrainState(params, adamw_init(named, OPT),
                       torch.zeros((), dtype=torch.int32))
    new, _ = make_train_step(cfg, OPT)(state, batch)
    return (logits, aux, metrics["loss"], dict(zip(names, grads)),
            dict(new.params.named_parameters()))


def compute_rank(shape: tuple[int, ...]) -> dict | None:
    """Every arch on this rank's part of the mesh ``shape``; rank 0
    returns the gathered results by arch, the others None."""
    mesh = lm.make_serve_mesh(shape, device_type="cpu")
    ctx = sh.ShardingCtx(mesh)
    out = {}
    for arch in ARCHS:
        cfg = cfg_of(arch)
        params = params_of(cfg)
        shd = sh.param_shardings(T.param_logical_axes(params),
                                 dict(params.named_parameters()), ctx)
        model = T.from_named(cfg, {n: sh.distribute(p.detach(), shd[n])
                                   for n, p in params.named_parameters()})
        batch = {k: sh.distribute(v, ctx.named(("batch", None), v.shape))
                 for k, v in batch_of(cfg).items()}
        with sh.use(ctx):
            logits, aux, loss, grads, new = _step(model, cfg, batch)
            out[arch] = {
                "sharded": sum(p.to_local().shape != p.shape
                               for p in model.parameters()),
                "logits": _np(logits), "aux": float(_np(aux)),
                "loss": float(_np(loss)),
                "grads": {k: _np(g) for k, g in grads.items()},
                "new": {k: _np(p) for k, p in new.items()},
            }
    return out if torch.distributed.get_rank() == 0 else None


def unsharded(arch: str) -> dict:
    cfg = cfg_of(arch)
    logits, aux, loss, grads, new = _step(params_of(cfg), cfg,
                                          batch_of(cfg))
    return {"logits": _np(logits), "aux": float(aux), "loss": float(loss),
            "grads": {k: _np(g) for k, g in grads.items()},
            "new": {k: _np(p) for k, p in new.items()}}


def check_forward(got: dict, want: dict) -> None:
    assert got["sharded"] > 0, "no parameter was split over the mesh"
    np.testing.assert_allclose(got["logits"], want["logits"], atol=FWD_TOL,
                               rtol=FWD_TOL)
    assert abs(got["aux"] - want["aux"]) <= FWD_TOL * max(1, abs(want["aux"]))
    assert abs(got["loss"] - want["loss"]) <= FWD_TOL * max(1, want["loss"])


def check_grads(got: dict, want: dict) -> None:
    assert got["grads"].keys() == want["grads"].keys()
    for name, w in want["grads"].items():
        np.testing.assert_allclose(
            got["grads"][name], w, rtol=0,
            atol=GRAD * max(np.abs(w).max(), 1e-30), err_msg=name)


def check_update(got: dict, want: dict) -> None:
    assert got["new"].keys() == want["new"].keys()
    for name, w in want["new"].items():
        g = want["grads"][name]
        loud = np.abs(g) > QUIET * np.abs(g).max()
        np.testing.assert_allclose(got["new"][name][loud], w[loud],
                                   atol=STEP_TOL, rtol=STEP_TOL,
                                   err_msg=name)


CHECKS = {"forward": check_forward, "grads": check_grads,
          "update": check_update}


@pytest.fixture(scope="module", params=[2, 4], ids=["model2", "model4"])
def ranks(request):
    return lm.run_ranks(compute_rank, request.param, (request.param,))[0]


@pytest.fixture(scope="module")
def plain():
    return {arch: unsharded(arch) for arch in ARCHS}


@pytest.mark.parametrize("check", sorted(CHECKS))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_mesh_equals_unsharded(ranks, plain, arch, check):
    CHECKS[check](ranks[arch], plain[arch])
