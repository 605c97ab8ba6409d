"""The port's ``make_train_step`` against the reference's on the CPU:
three steps of granite-8b, deepseek-v2-lite-16b (MLA + MoE) and
mamba2-1.3b (SSD) smoke configs in float32, plain, with
``microbatches=2`` and with ``compress_grads=True``.

The state starts as the reference's (``state_from_jax``); the batches
are ``SyntheticLM``'s, the learning rate the cosine schedule. Tolerance
5e-5 atol/rtol on the metrics (loss, ce, aux, grad_norm, clip_scale, lr)
and on every parameter and moment, the tolerance
``tests/test_training.py:213-228`` holds two orderings of one step to.

Compressed steps are taken one at a time from the reference's state
(carried across before each): int8 rounding is discontinuous, so an
element whose value (gradient plus residual) lies within the two sides'
arithmetic noise of a rounding boundary may quantize one level apart,
and AdamW turns a level into a whole step. For such elements (|frac(u) -
1/2| < 1e-3, u the value over the scale of its stacked leaf: the
reference quantizes ``units/b{i}/<name>`` whole) the gradient is compared
instead, within 1e-4 of the leaf's max |g|, and the grad norm within the
bound those elements' levels allow; every other element is held to 5e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import cosine_schedule as jcosine
from repro.train import loop as JLoop
from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.convert import state_from_jax
from repro_torch.optim import AdamWConfig, cosine_schedule
from repro_torch.train.loop import loss_fn, make_train_step, stacked_leaf

TOL = 5e-5
ARCHS = ("granite-8b", "deepseek-v2-lite-16b", "mamba2-1.3b")
#: an element this close (in quantization levels) to a rounding boundary
#: quantizes as the two sides' noise decides
BOUNDARY = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, compress=False, **kw):
    jcfg, cfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    js = JLoop.init_state(jcfg, JAdamWConfig(lr=1e-3), jax.random.key(0),
                          compress=compress)
    jstep = jax.jit(JLoop.make_train_step(
        jcfg, JAdamWConfig(lr=1e-3), lr_fn=jcosine(1e-3, 1, 3),
        compress_grads=compress, **kw))
    step = make_train_step(cfg, AdamWConfig(lr=1e-3),
                           lr_fn=cosine_schedule(1e-3, 1, 3),
                           compress_grads=compress, **kw)
    data = SyntheticLM(cfg.vocab_size, 16, 4, seed=1)
    return cfg, js, jstep, step, data


def _port(js, cfg):
    return state_from_jax(jax.tree.map(np.asarray, js), cfg)


def _trees(state):
    out = {"params": state.named(), "m": state.opt_state["m"],
           "v": state.opt_state["v"]}
    if state.ef_state is not None:
        out["ef"] = state.ef_state
    return out


def _metrics_close(m, jm, skip=()):
    assert set(m) == set(jm)
    for k in jm:
        if k not in skip:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=TOL,
                                       rtol=TOL, err_msg=k)


@pytest.mark.parametrize("mode", ["plain", "microbatches"])
@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_match_the_reference(arch, mode):
    kw = {"microbatches": 2} if mode == "microbatches" else {}
    cfg, js, jstep, step, data = _setup(arch, **kw)
    state = _port(js, cfg)
    state0 = state.clone()
    for s in range(3):
        b = data.batch(s)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        _metrics_close(m, jm)
    assert int(state.step) == int(js.step) == 3
    assert int(state.opt_state["count"]) == 3
    want = _trees(_port(js, cfg))
    for tree, leaves in _trees(state).items():
        for name, t in leaves.items():
            np.testing.assert_allclose(t.numpy(), want[tree][name].numpy(),
                                       atol=TOL, rtol=TOL,
                                       err_msg=f"{tree} {name}")
    for tree, leaves in _trees(state0).items():     # the start is untouched
        first = _trees(_port(JLoop.init_state(
            jconfigs.get_smoke_config(arch), JAdamWConfig(lr=1e-3),
            jax.random.key(0)), cfg))[tree]
        for name, t in leaves.items():
            assert torch.equal(t, first[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_a_step_from_the_references_state_matches_its_next_step(arch):
    """One reference step, carried across: the port's next step from that
    state equals the reference's next step."""
    cfg, js, jstep, step, data = _setup(arch)
    js, _ = jstep(js, {k: jnp.asarray(v) for k, v in data.batch(0).items()})
    state = _port(js, cfg)
    b = data.batch(1)
    js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
    state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
    _metrics_close(m, jm)
    want = _trees(_port(js, cfg))
    for tree, leaves in _trees(state).items():
        for name, t in leaves.items():
            np.testing.assert_allclose(t.numpy(), want[tree][name].numpy(),
                                       atol=TOL, rtol=TOL,
                                       err_msg=f"{tree} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_compressed_steps_match_the_reference(arch):
    cfg, js, jstep, step, data = _setup(arch, compress=True)
    jcfg = jconfigs.get_smoke_config(arch)
    for s in range(3):
        b = data.batch(s)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        state = _port(js, cfg)
        # each side's raw gradient at this state
        jg = jax.grad(lambda p: JLoop.loss_fn(p, jcfg, jb)[0])(js.params)
        jraw = _port(dataclasses.replace(js, params=jg), cfg).named()
        names, leaves = zip(*state.params.named_parameters())
        total, _ = loss_fn(state.params, cfg, tb)
        raw = dict(zip(names, torch.autograd.grad(total, leaves)))
        ef = state.ef_state
        js, jm = jstep(js, jb)
        state, m = step(state, tb)
        want = _trees(_port(js, cfg))
        got = _trees(state)
        bound = 0.0
        xs = {name: (jraw[name] + ef[name]).numpy() for name in names}
        amax = {}
        for name, x in xs.items():     # one scale per stacked leaf
            key = stacked_leaf(cfg, name)
            amax[key] = max(amax.get(key, 0.0), float(np.abs(x).max()))
        for name in names:
            x = xs[name]
            scale = max(amax[stacked_leaf(cfg, name)], 1e-12) / 127.0
            u = x / scale
            edge = np.abs(np.abs(u - np.floor(u)) - 0.5) < BOUNDARY
            bound += float(((2 * np.abs(u[edge]) + 2) * scale ** 2).sum())
            np.testing.assert_allclose(
                (raw[name] + ef[name]).numpy()[edge], x[edge], rtol=0,
                atol=1e-4 * np.abs(x).max(), err_msg=name)
            for tree in got:
                np.testing.assert_allclose(
                    got[tree][name].numpy()[~edge],
                    want[tree][name].numpy()[~edge], atol=TOL, rtol=TOL,
                    err_msg=f"step {s} {tree} {name}")
        _metrics_close(m, jm, skip=("grad_norm", "clip_scale"))
        gn, jgn = float(m["grad_norm"]), float(jm["grad_norm"])
        assert abs(gn ** 2 - jgn ** 2) <= bound + 2 * TOL * jgn ** 2
        cs = min(1.0, 1.0 / max(gn, 1e-9))
        assert float(m["clip_scale"]) == pytest.approx(cs, rel=1e-6)
