"""The port's training substrate against the JAX package on the CPU:
AdamW and its schedule, the synthetic data pipeline, gradient
compression, checkpoint/restart, the watchdog, remat, and the flash
wrapper's refusal under grad.

Tolerances: AdamW against a float64 numpy loop 1e-5 (the reference's own
test) and against ``repro.optim.adamw_update`` on the same leaves 1e-6
(float32 arithmetic in one order on both sides); the cosine schedule
within one float32 ulp of its cosine of the reference's (``cos`` may
round apart, and near the schedule's end 1 + cos cancels, so 2^-24 of
the base rate absolute);
data batches, compression's int8 values and scales, checkpoints and the
preempted-and-resumed run bit for bit; remat ``full``, ``dots`` and off
give bit-equal gradients (recomputation repeats the same arithmetic).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw as jadamw
from repro.parallel import compression as jcompression
from repro.train import loop as JLoop
from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM, make_batch_specs
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import transformer as T
from repro_torch.models.convert import state_from_jax
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule)
from repro_torch.parallel import compression
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import (SimulatedPreemption, StepWatchdog,
                                     run_training)
from repro_torch.train.loop import (init_state, loss_fn, make_train_step,
                                    stacked_leaf)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny models: one intra-op thread keeps a parallel run from
    oversubscribing the host. Results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# -- AdamW ---------------------------------------------------------------------


def numpy_adamw(params, grads, m, v, t, cfg, lr):
    """tests/test_training.py's float64 loop, copied."""
    gnorm = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                        for g in grads.values()))
    scale = min(1.0, cfg.clip_norm / max(gnorm, 1e-9))
    out_p, out_m, out_v = {}, {}, {}
    for k in params:
        g = grads[k].astype(np.float64) * scale
        m2 = cfg.b1 * m[k] + (1 - cfg.b1) * g
        v2 = cfg.b2 * v[k] + (1 - cfg.b2) * g * g
        mh = m2 / (1 - cfg.b1 ** t)
        vh = v2 / (1 - cfg.b2 ** t)
        step = mh / (np.sqrt(vh) + cfg.eps) + cfg.weight_decay * params[k]
        out_p[k] = params[k] - lr * step
        out_m[k], out_v[k] = m2, v2
    return out_p, out_m, out_v


def test_adamw_matches_numpy_reference():
    cfg = AdamWConfig(lr=1e-2)
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((4, 5)).astype(np.float32),
              "b": rng.standard_normal((7,)).astype(np.float32)}
    tparams = {k: torch.from_numpy(p.copy()) for k, p in params.items()}
    state = adamw_init(tparams, cfg)
    m = {k: np.zeros_like(p, dtype=np.float64) for k, p in params.items()}
    v = {k: np.zeros_like(p, dtype=np.float64) for k, p in params.items()}
    cur = {k: p.copy() for k, p in params.items()}
    for t in range(1, 4):
        grads = {k: rng.standard_normal(p.shape).astype(np.float32)
                 for k, p in params.items()}
        tparams, state, _ = adamw_update(
            {k: torch.from_numpy(g) for k, g in grads.items()}, state,
            tparams, cfg, 1e-2)
        cur, m, v = numpy_adamw(cur, grads, m, v, t, cfg, 1e-2)
    for k in params:
        np.testing.assert_allclose(_np(tparams[k]), cur[k], atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("in_place", [False, True], ids=["new", "in_place"])
def test_adamw_matches_the_reference_update(moments, in_place):
    """Three updates with a clip that bites and a tensor lr, against
    ``repro.optim.adamw_update`` on the same leaves; the metrics too. In
    place, the given tensors are the ones returned; otherwise the inputs
    are left as they were."""
    cfg = AdamWConfig(lr=1e-2, clip_norm=0.5, moment_dtype=moments)
    jcfg = JAdamWConfig(lr=1e-2, clip_norm=0.5, moment_dtype=moments)
    rng = np.random.default_rng(1)
    params = {"w": rng.standard_normal((6, 9)).astype(np.float32),
              "b": rng.standard_normal((9,)).astype(np.float32)}
    jp = {k: jnp.asarray(p) for k, p in params.items()}
    js = jadamw.adamw_init(jp, jcfg)
    tp = {k: torch.from_numpy(p.copy()) for k, p in params.items()}
    ts = adamw_init(tp, cfg)
    for t in range(3):
        grads = {k: rng.standard_normal(p.shape).astype(np.float32)
                 for k, p in params.items()}
        lr = np.float32(1e-2 * (t + 1))
        jp, js, jm = jadamw.adamw_update(
            {k: jnp.asarray(g) for k, g in grads.items()}, js, jp, jcfg,
            jnp.asarray(lr))
        before = {k: p.clone() for k, p in tp.items()}
        ids = {k: id(p) for k, p in tp.items()}
        tp2, ts2, tm = adamw_update(
            {k: torch.from_numpy(g) for k, g in grads.items()}, ts, tp, cfg,
            torch.tensor(lr), in_place=in_place)
        if in_place:
            assert {k: id(p) for k, p in tp2.items()} == ids
            assert ts2["count"] is ts["count"]
        else:
            for k in tp:
                assert torch.equal(tp[k], before[k])
        tp, ts = tp2, ts2
        for k in params:
            np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]),
                                       atol=1e-6, rtol=1e-6)
            for mom in ("m", "v"):
                assert ts[mom][k].dtype == getattr(torch, moments)
                np.testing.assert_allclose(
                    _np(ts[mom][k].float()),
                    np.asarray(js[mom][k], np.float32), atol=1e-6, rtol=1e-6)
        assert int(ts["count"]) == int(js["count"]) == t + 1
        for name in ("grad_norm", "clip_scale"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-6)


def test_cosine_schedule_equals_the_reference():
    ours = cosine_schedule(1.0, warmup=10, total=110)
    theirs = jadamw.cosine_schedule(1.0, warmup=10, total=110)
    got = np.array([float(ours(s)) for s in range(121)], np.float32)
    want = np.array([float(theirs(s)) for s in range(121)], np.float32)
    # one float32 ulp of the cosine apart at most: near the end of the
    # schedule 1 + cos(pi t) cancels, so that ulp is absolute, 2^-24 of
    # base_lr, not relative to the small result
    np.testing.assert_allclose(got, want, rtol=2.0 ** -23, atol=2.0 ** -24)
    assert float(ours(0)) == 0.0
    assert float(ours(10)) == pytest.approx(1.0)
    assert float(ours(110)) == pytest.approx(0.0, abs=1e-6)
    assert float(ours(5)) == pytest.approx(0.5)
    step = torch.tensor(7, dtype=torch.int32)
    assert ours(step).dtype == torch.float32 and ours(step).ndim == 0


def test_bf16_moments_halve_memory():
    params = {"w": torch.zeros((128, 128))}
    s32 = adamw_init(params, AdamWConfig(moment_dtype="float32"))
    s16 = adamw_init(params, AdamWConfig(moment_dtype="bfloat16"))
    assert s16["m"]["w"].dtype == torch.bfloat16
    nbytes = lambda t: t.numel() * t.element_size()
    assert nbytes(s16["m"]["w"]) * 2 == nbytes(s32["m"]["w"])


# -- data ----------------------------------------------------------------------


@pytest.mark.parametrize("hosts", [1, 4])
def test_synthetic_batches_equal_the_reference(hosts):
    for host in range(hosts):
        ours = SyntheticLM(100, 16, 8, seed=3, host_id=host, num_hosts=hosts)
        theirs = jpipeline.SyntheticLM(100, 16, 8, seed=3, host_id=host,
                                       num_hosts=hosts)
        for s in (0, 5, 17):
            a, b = ours.batch(s), theirs.batch(s)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_host_sharding_partitions_the_global_batch():
    full = SyntheticLM(100, 16, 8, seed=3)
    parts = [SyntheticLM(100, 16, 8, seed=3, host_id=i, num_hosts=4)
             for i in range(4)]
    got = np.concatenate([p.batch(2)["tokens"] for p in parts])
    np.testing.assert_array_equal(got, full.batch(2)["tokens"])
    with pytest.raises(ValueError):
        SyntheticLM(100, 16, 6, num_hosts=4)


@pytest.mark.parametrize("arch", ["granite-8b", "internvl2-2b",
                                  "hubert-xlarge"])
def test_batch_specs_equal_the_reference(arch):
    a = make_batch_specs(configs.get_smoke_config(arch), 2, 16)
    b = jpipeline.make_batch_specs(jconfigs.get_smoke_config(arch), 2, 16)
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


# -- compression -----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_values_and_scale_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(1000) * 10.0 ** rng.uniform(-6, 2)
         ).astype(np.float32)
    q, s = compression.quantize_int8(torch.from_numpy(x))
    jq, js = jcompression.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(_np(q), np.asarray(jq))
    assert _np(s).tobytes() == np.asarray(js).tobytes()
    ef = (rng.standard_normal(1000) * 1e-3).astype(np.float32)
    g, res = compression.compress_leaf(torch.from_numpy(x),
                                       torch.from_numpy(ef))
    jg, jres = jcompression.compress_leaf(jnp.asarray(x), jnp.asarray(ef))
    np.testing.assert_array_equal(_np(g), np.asarray(jg))
    np.testing.assert_array_equal(_np(res), np.asarray(jres))
    err = np.abs(_np(compression.dequantize_int8(q, s)) - x)
    assert err.max() <= float(s) / 2 + 1e-9


def test_grouped_compression_equals_the_references_stacked_leaf():
    """Leaves of one group share the scale of their stacked whole: the
    port's per-layer slices of ``units/b0/w`` against the reference's
    ``compress_leaf`` of the stacked (2, 5, 7) leaf, bit for bit."""
    rng = np.random.default_rng(4)
    g = rng.standard_normal((2, 5, 7)).astype(np.float32)
    g[1] *= 30.0                  # the second layer sets the scale
    ef = (rng.standard_normal((2, 5, 7)) * 1e-2).astype(np.float32)
    jg, jef = jcompression.compress_leaf(jnp.asarray(g), jnp.asarray(ef))
    names = ["blocks.0.w", "blocks.1.w", "embed"]
    grads = {"blocks.0.w": torch.from_numpy(g[0]),
             "blocks.1.w": torch.from_numpy(g[1]),
             "embed": torch.from_numpy(g[0] * 2)}
    efs = {"blocks.0.w": torch.from_numpy(ef[0]),
           "blocks.1.w": torch.from_numpy(ef[1]), "embed": torch.zeros(5, 7)}
    cfg = configs.get_smoke_config("granite-8b")
    groups = {k: stacked_leaf(cfg, k) for k in names}
    assert groups == {"blocks.0.w": "units/b0/w", "blocks.1.w": "units/b0/w",
                      "embed": "embed"}
    out, res = compression.compress_tree(grads, efs, groups)
    for i in range(2):
        np.testing.assert_array_equal(_np(out[f"blocks.{i}.w"]),
                                      np.asarray(jg)[i])
        np.testing.assert_array_equal(_np(res[f"blocks.{i}.w"]),
                                      np.asarray(jef)[i])
    want, _ = compression.compress_leaf(grads["embed"], efs["embed"])
    assert torch.equal(out["embed"], want)


def test_error_feedback_unbiased_over_time():
    rng = np.random.default_rng(0)
    g_true = [rng.standard_normal(64).astype(np.float32) * 0.01
              for _ in range(50)]
    ef = torch.zeros(64)
    applied = np.zeros(64)
    for g in g_true:
        deq, ef = compression.compress_leaf(torch.from_numpy(g), ef)
        applied += _np(deq)
    resid = np.abs(applied + _np(ef) - np.sum(g_true, axis=0)).max()
    assert resid < 1e-4


def _data_fn(vocab, seq=16, batch=4):
    data = SyntheticLM(vocab, seq, batch, seed=1)

    def data_fn(s):
        return {k: torch.from_numpy(v) for k, v in data.batch(s).items()}
    return data_fn


def test_compressed_training_converges():
    cfg = configs.get_smoke_config("granite-8b")
    opt = AdamWConfig(lr=1e-3)
    data_fn = _data_fn(cfg.vocab_size)
    losses = {}
    for compress in (False, True):
        state = init_state(cfg, opt, torch.Generator().manual_seed(0), "cpu",
                           compress=compress)
        step = make_train_step(cfg, opt, compress_grads=compress)
        ls = []
        for s in range(25):
            state, m = step(state, data_fn(s))
            ls.append(float(m["ce"]))
        losses[compress] = np.mean(ls[-5:])
    assert losses[True] < losses[False] * 1.15


# -- checkpoint / restart ----------------------------------------------------------


def _tiny(seed=0, compress=False):
    cfg = configs.get_smoke_config("granite-8b")
    opt = AdamWConfig(lr=1e-3)
    state = init_state(cfg, opt, torch.Generator().manual_seed(seed), "cpu",
                       compress=compress)
    return cfg, state, make_train_step(cfg, opt, compress_grads=compress), \
        _data_fn(cfg.vocab_size)


def _leaves(state):
    return list(ckpt.leaves(state))


def _assert_equal_states(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), k


@pytest.mark.parametrize("compress", [False, True])
def test_checkpoint_roundtrip_and_manifest(tmp_path, compress):
    _, state, step, data_fn = _tiny(compress=compress)
    state, _ = step(state, data_fn(0))
    path = ckpt.save(str(tmp_path), 1, state)
    assert path.endswith("step-00000001.npz")
    restored, got_step = ckpt.restore(str(tmp_path), state)
    assert got_step == 1
    _assert_equal_states(state, restored)
    for (_, a), (_, b) in zip(_leaves(state), _leaves(restored)):
        assert a.data_ptr() != b.data_ptr()
    assert all(p.requires_grad for p in restored.params.parameters())
    manifest = json.loads((tmp_path / "step-00000001.json").read_text())
    assert manifest["step"] == 1
    assert set(manifest["leaves"]) == {k for k, _ in _leaves(state)}
    assert manifest["leaves"]["step"] == {"shape": [], "dtype": "int32"}
    assert manifest["leaves"]["params//embed"]["dtype"] == "float32"
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp")]


def test_checkpoint_keeps_bfloat16_bits(tmp_path):
    tree = {"w": torch.randn(5, 3, generator=torch.Generator().manual_seed(0)
                             ).to(torch.bfloat16),
            "n": {"c": torch.arange(4, dtype=torch.int32)}}
    ckpt.save(str(tmp_path), 3, tree)
    back, _ = ckpt.restore(str(tmp_path), tree)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], tree["w"])
    assert torch.equal(back["n"]["c"], tree["n"]["c"])
    manifest = json.loads((tmp_path / "step-00000003.json").read_text())
    assert manifest["leaves"]["w"]["dtype"] == "bfloat16"


def test_retention(tmp_path):
    for s in range(1, 6):
        ckpt.save(str(tmp_path), s, {"x": torch.ones(3)}, keep=2)
    assert ckpt.all_steps(str(tmp_path)) == [4, 5]
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), {"x": torch.ones(3)})


@pytest.mark.parametrize("compress", [False, True])
def test_preempt_resume_bit_exact(tmp_path, compress):
    """Kill at step 7 of 12, resume from the checkpoint of step 6: the
    final state equals the uninterrupted run's bit for bit, and the one
    ``state0`` handed to all three runs is left as it was."""
    _, state0, step, data_fn = _tiny(compress=compress)
    before = state0.clone()
    ref, _ = run_training(state0, step, data_fn, num_steps=12)
    cdir = str(tmp_path / "ckpt")
    with pytest.raises(SimulatedPreemption):
        run_training(state0, step, data_fn, num_steps=12, ckpt_dir=cdir,
                     ckpt_every=3, preempt_at=7)
    assert ckpt.all_steps(cdir) == [3, 6]
    resumed, _ = run_training(state0, step, data_fn, num_steps=12,
                              ckpt_dir=cdir, ckpt_every=3)
    _assert_equal_states(ref, resumed)
    assert int(resumed.step) == 12
    _assert_equal_states(state0, before)


def test_in_place_step_writes_the_state_it_is_given():
    """``in_place=True`` returns the state object it was given, its
    tensors updated, equal to the functional step's result."""
    cfg, state, step, data_fn = _tiny()
    want, wm = step(state, data_fn(0))
    opt = AdamWConfig(lr=1e-3)
    ptrs = [t.data_ptr() for _, t in _leaves(state)]
    got, gm = make_train_step(cfg, opt, in_place=True)(state, data_fn(0))
    assert got is state
    assert [t.data_ptr() for _, t in _leaves(got)] == ptrs
    _assert_equal_states(got, want)
    assert {k: float(v) for k, v in gm.items()} == {
        k: float(v) for k, v in wm.items()}


def test_loss_decreases():
    _, state, step, data_fn = _tiny()
    losses = []
    run_training(state, step, data_fn, num_steps=30,
                 on_metrics=lambda s, m: losses.append(float(m["ce"])))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_on_metrics_gets_numpy():
    _, state, step, data_fn = _tiny()
    seen = []
    run_training(state, step, data_fn, num_steps=1,
                 on_metrics=lambda s, m: seen.append(m))
    assert set(seen[0]) == {"loss", "ce", "aux", "tokens", "grad_norm",
                            "clip_scale", "lr"}
    assert all(isinstance(v, np.ndarray) for v in seen[0].values())


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(straggler_factor=2.0)
    flags = [wd.record(t) for t in [1.0, 1.0, 1.1, 5.0, 1.0, 4.0]]
    assert flags == [False, False, False, True, False, True]
    assert wd.stragglers == 2 and wd.steps == 6
    assert wd.ema is not None and wd.ema < 1.5


# -- state carried across ----------------------------------------------------------


def test_state_from_jax_carries_every_leaf():
    jcfg = jconfigs.get_smoke_config("deepseek-v2-lite-16b")
    cfg = configs.get_smoke_config("deepseek-v2-lite-16b")
    js = JLoop.init_state(jcfg, JAdamWConfig(), jax.random.key(0),
                          compress=True)
    js = dataclasses.replace(js, step=jnp.asarray(5, jnp.int32))
    st = state_from_jax(jax.tree.map(np.asarray, js), cfg)
    assert int(st.step) == 5 and st.step.dtype == torch.int32
    assert st.opt_state["count"].dtype == torch.int32
    named = st.named()
    assert set(named) == set(st.opt_state["m"]) == set(st.ef_state)
    assert sum(t.numel() for t in named.values()) == T.count_params(cfg)
    assert all(p.requires_grad for p in st.params.parameters())
    np.testing.assert_array_equal(_np(named["blocks.1.router"]),
                                  np.asarray(js.params["units"]["b0"]
                                             ["router"][1]))


# -- remat ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-1.3b",
                                  "jamba-1.5-large-398b"])
def test_remat_full_dots_and_off_give_equal_gradients(arch):
    base = configs.get_smoke_config(arch)
    params = T.init_params(base, torch.Generator().manual_seed(0),
                           "cpu").requires_grad_(True)
    batch = {k: torch.from_numpy(v)
             for k, v in make_batch_specs(base, 2, 16).items()}
    names, leaves = zip(*params.named_parameters())
    out = {}
    for label, kw in (("off", dict(remat=False)), ("full", dict(remat=True)),
                      ("dots", dict(remat=True, remat_policy="dots"))):
        cfg = dataclasses.replace(base, **kw)
        total, _ = loss_fn(params, cfg, batch)
        out[label] = (total, torch.autograd.grad(total, leaves))
    for label in ("full", "dots"):
        assert torch.equal(out[label][0], out["off"][0])
        for n, a, b in zip(names, out[label][1], out["off"][1]):
            assert torch.equal(a, b), (label, n)


def test_dots_policy_saves_the_unbatched_products_only():
    """Under ``dots`` the backward recomputes fewer matrix products than
    under ``full``: the saved ``x @ W`` outputs are not recomputed."""
    base = configs.get_smoke_config("granite-8b")
    params = T.init_params(base, torch.Generator().manual_seed(0),
                           "cpu").requires_grad_(True)
    batch = {k: torch.from_numpy(v)
             for k, v in make_batch_specs(base, 2, 16).items()}
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.mm += func == torch.ops.aten.mm.default
            return func(*args, **(kwargs or {}))

    counts = {}
    for label, kw in (("off", dict(remat=False)), ("full", dict(remat=True)),
                      ("dots", dict(remat=True, remat_policy="dots"))):
        cfg = dataclasses.replace(base, **kw)
        total, _ = loss_fn(params, cfg, batch)
        with Count() as c:
            torch.autograd.grad(total, list(params.parameters()))
        counts[label] = c.mm
    # full recomputes the projections whose outputs the backward reads
    # (all but w_down's, which only feeds the residual add); dots none
    assert counts["full"] == counts["off"] + 6 * base.num_layers
    assert counts["dots"] == counts["off"]


# -- serving stays gradient-free; flash refuses grad -----------------------------------


def test_serving_parameters_require_no_grad():
    cfg = configs.get_smoke_config("granite-8b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert not any(p.requires_grad for p in params.parameters())
    logits, _ = T.prefill(params, cfg, {"tokens": torch.zeros(
        (1, 4), dtype=torch.long)})
    assert logits.grad_fn is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_raises_under_grad_on_the_cpu(dtype):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((4, 32, 16), generator=g).to(dtype).requires_grad_(True)
    k = torch.randn((2, 32, 16), generator=g).to(dtype)
    kw = dict(num_q_heads=4, num_kv_heads=2)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(q, k, k, **kw)
    with torch.no_grad():
        assert fa.flash_attention(q, k, k, **kw).shape == q.shape
    assert fa.flash_attention(q.detach(), k, k, **kw).grad_fn is None
    cfg = dataclasses.replace(configs.get_smoke_config("granite-8b"),
                              attention_impl="flash")
    params = T.init_params(cfg, g, "cpu").requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        loss_fn(params, cfg, {"tokens": torch.zeros((1, 8), dtype=torch.long),
                              "labels": torch.zeros((1, 8), dtype=torch.long)})


# -- on the card -----------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch sees no CUDA device)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_raises_under_grad_on_the_card(dtype):
    dev = _card()
    q = torch.randn((4, 64, 64), device=dev).to(dtype).requires_grad_(True)
    k = torch.randn((2, 64, 64), device=dev).to(dtype)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(q, k, k, num_q_heads=4, num_kv_heads=2)


#: a gradient element at most this share of its leaf's max |g| is within
#: the two devices' arithmetic noise of Adam's ratio m / sqrt(v)
QUIET = 1e-3


def _grads(state, cfg, batch):
    names, leaves = zip(*state.params.named_parameters())
    total, _ = loss_fn(state.params, cfg, batch)
    return dict(zip(names, torch.autograd.grad(total, leaves)))


def steps_against_cpu(dev):
    """Three f32 steps on ``dev`` twice from one state, equal bit for bit;
    and each step from the CPU's state against the CPU's step. There the
    gradients agree within 1e-4 of each leaf's max |g|, and the new
    parameters and moments within 5e-5 wherever the gradient stands above
    QUIET of its leaf's max; below it, where the two sides' noise sets
    Adam's ratio m / sqrt(v), the gradient is compared instead."""
    cfg, state, step, data_fn = _tiny()
    on = lambda b: {k: v.to(dev) for k, v in b.items()}
    runs = []
    for _ in range(2):
        s = state.to(dev, copy=True)
        for i in range(3):
            s, _ = step(s, on(data_fn(i)))
        runs.append(s)
    _assert_equal_states(runs[0], runs[1])
    cpu = state
    for i in range(3):
        b = data_fn(i)
        there = cpu.to(dev, copy=True)
        g_cpu, g_dev = _grads(cpu, cfg, b), _grads(there, cfg, on(b))
        new_cpu, _ = step(cpu, b)
        new_dev, _ = step(there, on(b))
        trees = lambda st: (st.named(), st.opt_state["m"], st.opt_state["v"])
        for name, g in g_cpu.items():
            top = float(g.abs().max())
            np.testing.assert_allclose(_np(g_dev[name]), _np(g), rtol=0,
                                       atol=1e-4 * top, err_msg=name)
            loud = _np(g.abs() > QUIET * top)
            for a, b_ in zip(trees(new_dev), trees(new_cpu)):
                np.testing.assert_allclose(
                    _np(a[name])[loud], _np(b_[name])[loud], atol=5e-5,
                    rtol=5e-5, err_msg=f"step {i} {name}")
        cpu = new_cpu


@pytest.mark.gpu
def test_card_steps_equal_cpu_steps_and_repeat_bit_for_bit():
    steps_against_cpu(_card())


@pytest.mark.gpu
def test_preempt_resume_bit_exact_on_the_card(tmp_path):
    dev = _card()
    _, state0, step, data_fn = _tiny()
    state0 = state0.to(dev)
    data = lambda s: {k: v.to(dev) for k, v in data_fn(s).items()}
    ref, _ = run_training(state0, step, data, num_steps=12)
    cdir = str(tmp_path / "ckpt")
    with pytest.raises(SimulatedPreemption):
        run_training(state0, step, data, num_steps=12, ckpt_dir=cdir,
                     ckpt_every=3, preempt_at=7)
    resumed, _ = run_training(state0, step, data, num_steps=12,
                              ckpt_dir=cdir, ckpt_every=3)
    assert resumed.step.device.type == "cuda"
    _assert_equal_states(ref, resumed)
