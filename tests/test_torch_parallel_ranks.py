"""Elastic restore and the pipeline primitive on several CPU ranks.

Each test spawns one group of 4 gloo ranks (``launch.mesh.run_ranks``):

* elastic restore, the twin of the reference's ``TestElasticReshard`` at
  4 ranks: smoke granite's parameters laid out on a (2, 2) ("data",
  "model") mesh by ``param_shardings`` are saved (every rank gathers,
  rank 0 writes) and restored onto 2-rank meshes, (1, 2) and (2, 1), and
  onto a 1-device mesh; every leaf comes back bit-equal, as a ``DTensor``
  on the new mesh with the placements ``param_shardings`` resolves there;
* ``pipeline_apply`` against the sequential model at the shapes of the
  reference's ``tests/test_pipeline.py`` (S=4 M=8, S=2 with two units a
  stage M=6, S=4 M=1; the reference's own tests fail on jax 0.9): outputs
  within 1e-6, and gradients, by autograd through the pipeline, within
  1e-6 of each gradient's largest magnitude (the pipeline sums the
  microbatches' contributions one at a time, the batched loop in one
  product, so float32 rounds them apart by about 1e-7 of that scale).
"""

import numpy as np
import torch

from repro_torch import configs
from repro_torch.launch import mesh as lm
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.pipeline import pipeline_apply, stack_stages
from repro_torch.train import checkpoint as ckpt

TOL = 1e-6


def _elastic_rank(ckpt_dir: str) -> dict:
    cfg = configs.get_smoke_config("granite-8b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    axes = T.param_logical_axes(params)
    shapes = dict(params.named_parameters())
    mesh_a = lm.make_production_mesh(shape=(2, 2), device_type="cpu")
    shd_a = sh.param_shardings(axes, shapes, sh.ShardingCtx(mesh_a))
    pa = T.from_named(cfg, {n: sh.distribute(p.detach(), shd_a[n])
                            for n, p in params.named_parameters()})
    ckpt.save(ckpt_dir, 1, pa)
    out = {"split_a": sum(t.to_local().shape != t.shape
                          for t in pa.parameters())}
    for shape in ((1, 2), (2, 1), (1, 1)):
        mesh_b = lm.make_production_mesh(shape=shape, device_type="cpu")
        if mesh_b.get_coordinate() is None:
            continue
        shd_b = sh.param_shardings(axes, shapes, sh.ShardingCtx(mesh_b))
        pb, step = ckpt.restore(ckpt_dir, params, shardings=shd_b)
        leaves = dict(pb.named_parameters())
        out[shape] = {
            "step": step,
            "dtensors": all(sh.is_dtensor(t) and t.device_mesh is mesh_b
                            for t in leaves.values()),
            "placements": all(tuple(leaves[n].placements)
                              == shd_b[n].placements for n in leaves),
            "split": sum(t.to_local().shape != t.shape
                         for t in leaves.values()),
            "equal": all(torch.equal(sh.full_tensor(leaves[n]).detach(),
                                     p.detach())
                         for n, p in params.named_parameters()),
        }
    return out


def test_elastic_restore_across_4_2_1_ranks(tmp_path):
    ranks = lm.run_ranks(_elastic_rank, 4, str(tmp_path))
    assert all(r["split_a"] > 0 for r in ranks)
    for shape, members in (((1, 2), 2), ((2, 1), 2), ((1, 1), 1)):
        got = [r[shape] for r in ranks if shape in r]
        assert len(got) == members
        for g in got:
            assert g["step"] == 1 and g["dtensors"] and g["placements"]
            assert g["equal"], f"restore onto {shape} changed a leaf"
            # each of 2 ranks holds a part of some leaves; 1 holds all
            assert (g["split"] > 0) == (members > 1)
    # what the file holds is the plain tensors, bit for bit
    cfg = configs.get_smoke_config("granite-8b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    plain, step = ckpt.restore(str(tmp_path), params)
    assert step == 1 and all(
        torch.equal(a, b) for a, b in zip(plain.parameters(),
                                          params.parameters()))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step-00000001.json", "step-00000001.npz"]


CASES = ((4, 8), (2, 6), (4, 1))       # (stages, microbatches)
B, D = 2, 16


def _pipeline_rank() -> dict:
    ws = torch.randn(4, D, D, generator=torch.Generator().manual_seed(0)) * 0.3

    def stage_fn(w, x):
        for wi in w.reshape(-1, D, D):
            x = torch.tanh(x @ wi)
        return x

    out = {}
    for stages, micro in CASES:
        mesh = lm.make_production_mesh(shape=(stages,), axes=("stage",),
                                       device_type="cpu")
        if mesh.get_coordinate() is None:
            continue
        stage = mesh.get_coordinate()[0]
        units = 4 // stages
        params = stack_stages(ws, stages).clone().requires_grad_()
        x = torch.randn(micro, B, D, generator=torch.Generator().manual_seed(1)
                        ).requires_grad_()
        y = pipeline_apply(stage_fn, params, x, mesh=mesh)
        (y ** 2).sum().backward()
        ws2, x2 = ws.clone().requires_grad_(), x.detach().clone()
        x2.requires_grad_()
        ref = x2
        for s in range(4):
            ref = torch.tanh(ref @ ws2[s])
        (ref ** 2).sum().backward()
        mine = ws2.grad[stage * units:(stage + 1) * units]
        others = torch.cat([params.grad[:stage], params.grad[stage + 1:]])
        out[(stages, micro)] = {
            "shape": tuple(y.shape),
            "y_err": (y - ref).abs().max().item(),
            "grad_err": (params.grad[stage] - mine).abs().max().item(),
            "grad_scale": mine.abs().max().item(),
            "others_zero": bool((others == 0).all()),
            "x_grad_scale": x2.grad.abs().max().item(),
            "x_grad_err": ((x.grad - x2.grad).abs().max().item()
                           if stage == 0 else 0.0 if x.grad is None
                           else x.grad.abs().max().item()),
        }
    return out


def test_pipeline_equals_the_sequential_model_with_gradients():
    ranks = lm.run_ranks(_pipeline_rank, 4)
    for stages, micro in CASES:
        got = [r[(stages, micro)] for r in ranks if (stages, micro) in r]
        assert len(got) == stages
        for g in got:
            assert g["shape"] == (micro, B, D)
            assert g["y_err"] < TOL, g
            assert g["grad_err"] < TOL * g["grad_scale"], g
            assert g["others_zero"]
            # stage 0 takes x's gradient; the other stages hold zeros
            assert g["x_grad_err"] < TOL * g["x_grad_scale"], g
    assert np.isfinite([g["grad_err"] for r in ranks for g in r.values()]
                       ).all()
