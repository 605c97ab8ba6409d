"""The port's ``loss_fn`` and its gradients against ``jax.grad`` of the
reference's, for all ten architectures' smoke configs (front ends
included), in float32 on the CPU.

Weights come from the reference's ``init_state`` through
``state_from_jax``; the batch is ``make_batch_specs``' (numpy, seeded),
handed to both sides. Tolerances: loss, ce and aux within 1e-5 relative;
every gradient leaf within 1e-4 of that leaf's max |g| (the two sides do
the same arithmetic in another order). ``tokens`` is exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train import loop as JLoop
from repro_torch import configs
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.models.convert import state_from_jax
from repro_torch.train.loop import loss_fn

REL = 1e-5
GRAD = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_loss_and_gradients_match_jax_grad(arch):
    jcfg, cfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    js = JLoop.init_state(jcfg, JAdamWConfig(), jax.random.key(0))
    state = state_from_jax(jax.tree.map(np.asarray, js), cfg)
    batch = make_batch_specs(cfg, 2, 16)
    if cfg.frontend is None:      # a few masked labels
        batch["labels"][0, :3] = -1
    (_, jm), jg = jax.value_and_grad(
        lambda p: JLoop.loss_fn(p, jcfg, {k: jnp.asarray(v)
                                          for k, v in batch.items()}),
        has_aux=True)(js.params)
    total, m = loss_fn(state.params, cfg, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=REL,
                                   atol=REL, err_msg=k)
    assert float(m["tokens"]) == float(jm["tokens"])
    assert float(total.detach()) == float(m["loss"])
    names, leaves = zip(*state.params.named_parameters())
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    want = state_from_jax(jax.tree.map(
        np.asarray, dataclasses.replace(js, params=jg)), cfg).named()
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        w = want[name].numpy()
        got = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(got, w, rtol=0,
                                   atol=GRAD * max(np.abs(w).max(), 1e-30),
                                   err_msg=name)
