"""The port's other model families against the JAX reference on the CPU:
MLA + MoE (deepseek-v2-lite, phi3.5-moe), SSD (mamba2), the hybrid
(jamba), and the audio and vision front ends (hubert, internvl2).

Weights come from the reference's ``init_params`` through
``params_from_jax``; inputs are made with numpy from a seed and handed to
both sides, in float32 at the smoke configs. Tolerance 1e-4 on logits and
caches (the two sides do the same arithmetic in another order), 1e-4 on
the MoE aux loss; greedy tokens must be identical. The SSD recurrence is
also held to a float64 loop, as ``tests/test_models.py`` holds the
reference's. The SSM's softplus is the reference's own formula
(log(exp(x) + 1)), so no threshold separates the two sides.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import layers as JL
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.convert import cache_from_jax, params_from_jax
from repro_torch.serve.engine import ServeEngine

TOL = 1e-4
NEW = ("deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b", "mamba2-1.3b",
       "hubert-xlarge", "internvl2-2b", "jamba-1.5-large-398b")
DECODERS = tuple(a for a in NEW if a != "hubert-xlarge")
#: one arch of each cache family, as tests/test_serve_paged_equiv.py
ENGINE_ARCHS = ("mamba2-1.3b", "deepseek-v2-lite-16b",
                "jamba-1.5-large-398b")


def _lift(cfg):
    """Garbage rows share MoE capacity with real ones: lift the limit so
    routing is batch-independent wherever two schedules are compared
    (tests/test_serve_paged_equiv.py:35-39)."""
    return (dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
            if cfg.is_moe else cfg)


_MODELS: dict = {}


def _model(arch, lift=False, **kw):
    """(jax cfg, jax params, port cfg, port params) of the smoke config."""
    key = (arch, lift, tuple(sorted(kw.items())))
    if key not in _MODELS:
        jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **kw)
        cfg = dataclasses.replace(configs.get_smoke_config(arch), **kw)
        if lift:
            jcfg, cfg = _lift(jcfg), _lift(cfg)
        jparams = JT.init_params(jcfg, jax.random.key(0))
        _MODELS[key] = (jcfg, jparams, cfg, params_from_jax(
            jax.tree.map(np.asarray, jparams), cfg))
    return _MODELS[key]


def _batch(cfg, rng, b, s) -> dict:
    """numpy inputs: frames for audio, patches + tokens for vision."""
    out = {}
    if cfg.frontend == "audio":
        out["frames"] = rng.standard_normal(
            (b, s, cfg.frontend_dim)).astype(np.float32)
    else:
        if cfg.frontend == "vision":
            out["patches"] = rng.standard_normal(
                (b, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
        out["tokens"] = rng.integers(cfg.vocab_size, size=(b, s)).astype(
            np.int32)
    return out


def _torch(batch) -> dict:
    return {k: (torch.from_numpy(v).long() if v.dtype == np.int32
                else torch.from_numpy(v)) for k, v in batch.items()}


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().cpu().float().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


def _close_cache(cache, jcache, cfg):
    want = cache_from_jax(jax.tree.map(np.asarray, jcache), cfg)
    assert set(cache) == set(want)
    for name, leaf in want.items():
        assert cache[name].shape == leaf.shape, name
        _close(cache[name], leaf)


# -- configs, counts, shapes ---------------------------------------------------


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_count_params_equal_the_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert T.count_params(cfg) == jcfg.param_count()
    assert T.count_params(cfg, active_only=True) == jcfg.active_param_count()
    assert cfg.model_flops_per_token() == jcfg.model_flops_per_token()


def test_count_params_allocates_nothing():
    """jamba at full width is 398 B parameters: counted on ``meta``."""
    cfg = configs.get_config("jamba-1.5-large-398b")
    params = T.init_params(cfg, None, "meta")
    assert all(p.device.type == "meta" for p in params.parameters())
    assert T.count_params(cfg) == sum(p.numel() for p in params.parameters())
    assert 390e9 < T.count_params(cfg) < 400e9


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_shapes_and_cells_field_for_field(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert ([dataclasses.asdict(s) for s in configs.supported_cells(cfg)]
            == [dataclasses.asdict(s)
                for s in jconfigs.supported_cells(jcfg)])
    for name, shape in configs.SHAPES.items():
        jshape = jconfigs.SHAPES[name]
        assert dataclasses.asdict(shape) == dataclasses.asdict(jshape)
        assert (configs.cell_supported(cfg, shape)
                == jconfigs.cell_supported(jcfg, jshape))
        for scale in (1, 64):
            got = configs.input_specs(cfg, shape, scale)
            want = jconfigs.input_specs(jcfg, jshape, scale)
            assert list(got) == list(want)
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(want[k].shape), k
                assert str(t.dtype).split(".")[1] == str(want[k].dtype), k


# -- forward, prefill, decode ----------------------------------------------------


@pytest.mark.parametrize("arch", NEW)
def test_forward_logits_and_aux_match_jax(arch):
    jcfg, jparams, cfg, params = _model(arch)
    batch = _batch(cfg, np.random.default_rng(1), 2, 20)
    jlogits, jaux = JT.forward(jparams, dataclasses.replace(jcfg, remat=False),
                               jax.tree.map(jnp.asarray, batch))
    logits, aux = T.forward(params, cfg, _torch(batch))
    s = 20 + (cfg.num_patches if cfg.frontend == "vision" else 0)
    assert logits.shape == (2, s, cfg.vocab_size)
    _close(logits, jlogits)
    _close(aux, jaux)
    assert (float(aux) > 0) == cfg.is_moe


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_and_six_decode_steps_match_jax(arch):
    """Greedy tokens identical and logits and caches within 1e-4: three
    scalar-index steps, then three per-slot vector-index steps."""
    jcfg, jparams, cfg, params = _model(arch)
    rng = np.random.default_rng(2)
    b, s = 2, 20
    batch = _batch(cfg, rng, b, s)
    pos = s + (cfg.num_patches if cfg.frontend == "vision" else 0)
    max_len = pos + 8
    jlogits, jcache = JT.prefill(jparams, jcfg,
                                 jax.tree.map(jnp.asarray, batch),
                                 max_len=max_len)
    logits, cache = T.prefill(params, cfg, _torch(batch), max_len=max_len)
    assert logits.shape == (b, 1, cfg.vocab_size)
    _close(logits, jlogits)
    _close_cache(cache, jcache, cfg)
    for step in range(6):
        jtok = np.asarray(jnp.argmax(jlogits[:, -1], -1))
        tok = torch.argmax(logits[:, -1], -1).numpy()
        np.testing.assert_array_equal(tok, jtok)
        if step < 3:
            jidx, idx = jnp.int32(pos + step), pos + step
        else:
            at = np.array([pos + step, pos + step - 1], np.int32)
            jidx, idx = jnp.asarray(at), torch.from_numpy(at)
        jlogits, jcache = JT.decode(jparams, jcfg, jcache,
                                    jnp.asarray(jtok[:, None]), jidx)
        logits, cache = T.decode(params, cfg, cache,
                                 torch.from_numpy(tok[:, None]).long(), idx)
        _close(logits, jlogits)
    _close_cache(cache, jcache, cfg)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-2b"])
def test_front_end_parameters_and_embedding(arch):
    """The front end's leaves come across; the embedding of frames or
    patches (+ tokens) is the reference's (jax.nn.gelu: tanh)."""
    jcfg, jparams, cfg, params = _model(arch)
    assert set(params.frontend) == {k for k in jparams
                                    if k.startswith("frontend_")}
    batch = _batch(cfg, np.random.default_rng(3), 2, 6)
    _close(T._embed_inputs(params, cfg, _torch(batch)),
           JT._embed_inputs(jparams, jcfg, jax.tree.map(jnp.asarray, batch)))


def test_hubert_is_bidirectional():
    """A later frame changes an earlier frame's logits (no causal mask)."""
    _, _, cfg, params = _model("hubert-xlarge")
    batch = _torch(_batch(cfg, np.random.default_rng(4), 1, 8))
    a, _ = T.forward(params, cfg, batch)
    batch["frames"][0, -1] += 1.0
    b, _ = T.forward(params, cfg, batch)
    assert not torch.allclose(a[0, 0], b[0, 0])


# -- MLA -------------------------------------------------------------------------


def test_naive_and_absorbed_mla_decode_agree():
    """Absorbed-matmul MLA scores against the compressed cache: the same
    math as the naive expansion, within 1e-4, on the scalar and vector
    branches; and held to the reference's absorbed decode."""
    jcfg, jparams, cfg, params = _model("deepseek-v2-lite-16b", lift=True)
    rng = np.random.default_rng(5)
    toks = rng.integers(cfg.vocab_size, size=(2, 25)).astype(np.int32)
    _, cache = T.prefill(params, cfg, {"tokens": torch.from_numpy(
        toks[:, :24]).long()}, max_len=32)
    _, jcache = JT.prefill(jparams, jcfg, {"tokens": jnp.asarray(
        toks[:, :24])}, max_len=32)
    nxt = torch.from_numpy(toks[:, 24:]).long()
    for idx in (24, torch.tensor([24, 23])):
        naive, _ = T.decode(params, cfg, {k: v.clone()
                                          for k, v in cache.items()},
                            nxt, idx)
        acfg = dataclasses.replace(cfg, mla_absorbed=True)
        absorbed, _ = T.decode(params, acfg, {k: v.clone()
                                              for k, v in cache.items()},
                               nxt, idx)
        _close(absorbed, naive.numpy())
    want, _ = JT.decode(jparams, dataclasses.replace(jcfg, mla_absorbed=True),
                        jcache, jnp.asarray(toks[:, 24:]), jnp.int32(24))
    got, _ = T.decode(params, dataclasses.replace(cfg, mla_absorbed=True),
                      cache, nxt, 24)
    _close(got, want)


@pytest.mark.parametrize("absorbed", [False, True])
def test_mla_paged_step_matches_jax(absorbed):
    """A prefill chunk, then a decode step, on the same pool and tables;
    pools equal after each step."""
    jcfg, jparams, cfg, params = _model("deepseek-v2-lite-16b", lift=True,
                                        mla_absorbed=absorbed)
    _paged_pair(jcfg, jparams, cfg, params)


# -- MoE -------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "phi3.5-moe-42b-a6.6b"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_moe_block_matches_jax_with_and_without_drops(arch, capacity_factor):
    """The block alone on 64 tokens: at 0.25 the buffers overflow and
    choices are dropped (the clamp-then-mask gather)."""
    jcfg, jparams, cfg, params = _model(arch)
    jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
    cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    jp = jax.tree.map(lambda a: a[0], jparams["units"]["b0"])
    p = params.blocks[0]
    x = np.random.default_rng(6).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32)
    jy, jaux = JL.apply_moe_block(jp, jnp.asarray(x), jcfg)
    y, aux = L.apply_moe_block(p, torch.from_numpy(x), cfg)
    _close(y, jy)
    _close(aux, jaux)
    assert L.moe_capacity(64, cfg) == JL.moe_capacity(64, jcfg)


def test_moe_top_k_ties_go_to_the_lower_index():
    """A zero router makes every expert tie: jax.lax.top_k takes the
    lowest indices, and so must the port (then the same outputs)."""
    jcfg, jparams, cfg, params = _model("phi3.5-moe-42b-a6.6b")
    jp = jax.tree.map(lambda a: a[0], jparams["units"]["b0"])
    jp = {**jp, "router": jnp.zeros_like(jp["router"])}
    p = {**params.blocks[0], "router": torch.zeros_like(
        params.blocks[0]["router"])}
    x = np.random.default_rng(7).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)
    jy, jaux = JL.apply_moe_block(jp, jnp.asarray(x), jcfg)
    y, aux = L.apply_moe_block(p, torch.from_numpy(x), cfg)
    _close(y, jy)
    _close(aux, jaux)
    _, top = jax.lax.top_k(jnp.full((1, cfg.num_experts), 0.25), cfg.top_k)
    assert np.asarray(top).tolist() == [list(range(cfg.top_k))]


# -- SSD ---------------------------------------------------------------------------


def _ssd_inputs(s, g, seed=0):
    bs, h, p, n = 2, 4, 8, 16
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bs, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bs, s, h)))).astype(np.float32)
    a_log = (rng.standard_normal(h) * 0.5).astype(np.float32)
    b = (rng.standard_normal((bs, s, g, n)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((bs, s, g, n)) * 0.3).astype(np.float32)
    state = (rng.standard_normal((bs, h, n, p)) * 0.5).astype(np.float32)
    return x, dt, a_log, b, c, np.ones(h, np.float32), state


def _naive_ssd(x, dt, a_log, b, c, d_skip, state):
    """The per-token recurrence in float64."""
    bs, s, h, p = x.shape
    rep = h // b.shape[2]
    a = -np.exp(a_log.astype(np.float64))
    hstate = state.astype(np.float64)
    y = np.zeros((bs, s, h, p))
    bf = np.repeat(b.astype(np.float64), rep, axis=2)
    cf = np.repeat(c.astype(np.float64), rep, axis=2)
    xb = x.astype(np.float64) * dt[..., None]
    for t in range(s):
        hstate = (hstate * np.exp(dt[:, t] * a)[..., None, None]
                  + np.einsum("bhn,bhp->bhnp", bf[:, t], xb[:, t]))
        y[:, t] = (np.einsum("bhn,bhnp->bhp", cf[:, t], hstate)
                   + d_skip[None, :, None] * x[:, t])
    return y, hstate


@pytest.mark.parametrize("s,chunk", [(32, 8), (48, 16), (30, 8)])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("initial", [False, True])
def test_ssd_chunked_matches_jax_and_the_recurrence(s, chunk, g, initial):
    x, dt, a_log, b, c, d_skip, state = _ssd_inputs(s, g)
    init = state if initial else None
    y, hlast = S.ssd_chunked(*map(torch.from_numpy, (x, dt, a_log, b, c,
                                                     d_skip)), chunk,
                             None if init is None else torch.from_numpy(init))
    jy, jh = JS.ssd_chunked(*map(jnp.asarray, (x, dt, a_log, b, c, d_skip)),
                            chunk, None if init is None else jnp.asarray(init))
    _close(y, jy)
    _close(hlast, jh)
    y_ref, h_ref = _naive_ssd(x, dt, a_log, b, c, d_skip,
                              state if initial else np.zeros_like(state))
    _close(y, y_ref, 1e-3)
    _close(hlast, h_ref, 1e-3)


def test_ssm_chunked_prefill_with_slots_matches_jax():
    """apply_ssm's chunked-prefill branch: slot-resident rows (one fresh,
    one carrying state, one the scratch row twice), padded tails."""
    jcfg, jparams, cfg, params = _model("mamba2-1.3b")
    jp = jax.tree.map(lambda a: a[1], jparams["units"]["b0"])
    p = params.blocks[1]
    rng = np.random.default_rng(8)
    cache = S.init_ssm_cache(cfg, 5, torch.float32, "cpu")
    cache["conv"].normal_(generator=torch.Generator().manual_seed(0))
    cache["state"].normal_(generator=torch.Generator().manual_seed(1))
    jcache = {k: jnp.asarray(v.numpy()) for k, v in cache.items()}
    x = rng.standard_normal((4, 8, cfg.d_model)).astype(np.float32)
    slots = np.array([2, 0, 4, 4], np.int32)
    start = np.array([0, 8, 16, 0], np.int32)
    lens = np.array([8, 5, 3, 1], np.int32)
    jy, jc = JS.apply_ssm(jp, jnp.asarray(x), jcfg, cache=jcache,
                          cache_index=jnp.asarray(start),
                          slot_ids=jnp.asarray(slots),
                          seq_lens=jnp.asarray(lens))
    y, c = S.apply_ssm(p, torch.from_numpy(x), cfg, cache=cache,
                       cache_index=torch.from_numpy(start).long(),
                       slot_ids=torch.from_numpy(slots).long(),
                       seq_lens=torch.from_numpy(lens).long())
    _close(y, jy)
    for name in ("conv", "state"):     # rows 0-3; the scratch row is junk
        _close(c[name][:4], np.asarray(jc[name])[:4])


# -- chunked attention and the int8 cache -----------------------------------------


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_matches_jax_and_ref(causal, mask):
    rng = np.random.default_rng(9)
    b, s, h, hkv, d = 2, 64, 4, 2, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    valid = (np.arange(s)[None, :] < np.array([[50], [64]])) if mask else None
    cfg = dataclasses.replace(configs.get_smoke_config("granite-8b"),
                              attention_impl="chunked", attention_chunk=16)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("granite-8b"),
                               attention_impl="chunked", attention_chunk=16)
    kw = {} if valid is None else {"kv_len_mask": torch.from_numpy(valid)}
    got = L._sdpa(*map(torch.from_numpy, (q, k, v)), cfg, causal=causal,
                  **kw)
    want = JL._sdpa(*map(jnp.asarray, (q, k, v)), jcfg, causal=causal,
                    **({} if valid is None
                       else {"kv_len_mask": jnp.asarray(valid)}))
    _close(got, want)
    plain = L._sdpa(*map(torch.from_numpy, (q, k, v)),
                    dataclasses.replace(cfg, attention_impl="ref"),
                    causal=causal, **kw)
    _close(got, plain.numpy())


def test_chunked_prefill_matches_jax():
    jcfg, jparams, cfg, params = _model("granite-8b",
                                        attention_impl="chunked",
                                        attention_chunk=8)
    toks = np.random.default_rng(10).integers(cfg.vocab_size, size=(2, 32))
    want, _ = JT.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    got, _ = T.prefill(params, cfg, {"tokens": torch.from_numpy(toks)})
    _close(got, want)


def _jax_quant(x):
    """The reference's int8 quantizer (repro/models/layers.py:335-339)."""
    s = jnp.maximum(jnp.abs(x).max(axis=-1), 1e-6) / 127.0
    return (jnp.clip(jnp.round(x / s[..., None]), -127, 127).astype(jnp.int8),
            s.astype(jnp.float32))


def test_int8_quantizer_is_the_reference_s_bit_for_bit():
    """Same inputs, same int8 values and scales, half-way points (round
    half to even) included."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32)
    x[0, 0, 0] = np.arange(16, dtype=np.float32) - 7.5   # ties at s = 1/127 * 8.5
    x[0, 1, 1] = 0.0                                      # the 1e-6 floor
    q, sc = L._quant_int8(torch.from_numpy(x))
    jq, jsc = _jax_quant(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))


def test_int8_scalar_decode_matches_jax_and_forward():
    """The int8 branch is reached with a scalar index from an int8
    init_cache (tests/test_models.py:133). Each step starts both sides
    from the port's cache, so they quantize the same history: logits
    within 1e-3 of the reference's wherever the new token's int8 values
    agree. Where the two sides' K/V differ by an ulp at a half-way point
    of a quantum, one int8 value rounds the other way (and moves the
    later layers' K/V a little): such a step may differ by one quantum in
    the new token's values only, and its logits and scales within 1e-2;
    all but one step must agree exactly. Run free, the port's logits stay within 3%
    of the exact forward."""
    jcfg, jparams, cfg, params = _model("granite-8b")
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    jcfg8 = dataclasses.replace(jcfg, kv_cache_dtype="int8")
    b, s = 2, 16
    toks = np.random.default_rng(11).integers(cfg.vocab_size,
                                              size=(b, s + 1))
    full, _ = T.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    cache = T.init_cache(cfg8, b, s + 4, "cpu")
    assert cache["k"].dtype == torch.int8
    assert set(cache) == {"k", "v", "k_scale", "v_scale"}
    agreed = 0
    for t in range(s + 1):
        col = toks[:, t:t + 1]
        jcache = {"b0": {k: jnp.asarray(v.numpy()) for k, v in cache.items()}}
        jlogits, jcache = JT.decode(jparams, jcfg8, jcache, jnp.asarray(col),
                                    jnp.int32(t))
        logits, cache = T.decode(params, cfg8, cache,
                                 torch.from_numpy(col), t)
        want = cache_from_jax(jax.tree.map(np.asarray, jcache), cfg8)
        flips = 0
        for name in ("k", "v"):
            diff = (cache[name].int() - want[name].int()).abs()
            assert not diff[:, :, :t].any() and not diff[:, :, t + 1:].any()
            assert int(diff.max()) <= 1
            flips += int((diff != 0).sum())
        tol = 1e-3 if flips == 0 else 1e-2
        for name in ("k_scale", "v_scale"):
            _close(cache[name], want[name], tol)
        _close(logits, jlogits, tol)
        agreed += flips == 0
    assert agreed >= s
    a, z = full[:, s].numpy(), logits[:, 0].numpy()
    assert np.abs(a - z).max() / (np.abs(a).max() + 1e-9) < 0.03


# -- engines and the launcher ------------------------------------------------------


ARGS = argparse.Namespace(seed=0, requests=6, max_len=48, slots=3,
                          engine="dense")


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_dense_engine_tokens_and_stats_match_jax(arch):
    jcfg, jparams, cfg, params = _model(arch, lift=True)
    jeng = JServeEngine(jcfg, jparams, max_slots=ARGS.slots,
                        max_len=ARGS.max_len)
    eng = ServeEngine(cfg, params, max_slots=ARGS.slots, max_len=ARGS.max_len)
    for jr, r in zip(jserve._workload(jcfg, ARGS), serve._workload(cfg, ARGS)):
        jeng.submit(jr)
        eng.submit(r)
    want = {r.uid: r.generated for r in jeng.run_to_completion()}
    got = {r.uid: r.generated for r in eng.run_to_completion()}
    assert got == want and len(got) == ARGS.requests
    assert eng.stats() == jeng.stats()
    assert eng.hbm_reserved_bytes() == jeng.hbm_reserved_bytes()


def test_encoder_has_no_engine():
    _, _, cfg, params = _model("hubert-xlarge")
    with pytest.raises(ValueError, match="encoder-only"):
        ServeEngine(cfg, params, max_slots=1, max_len=8)


def _lines(text: str) -> list[str]:
    """Printed lines with the wall times and the device masked."""
    import re
    text = re.sub(r"\d[\d,]*\.\d ms \([\d,]+ tok/s wall\)", "<wall>", text)
    return [line.replace(" device=cpu", "") for line in text.splitlines()]


def test_launcher_paged_mamba2_prints_the_reference_s_lines(capsys,
                                                            monkeypatch):
    """``--arch mamba2-1.3b --smoke --engine paged --device cpu`` on the
    reference's weights prints what the reference's launcher prints."""
    argv = ["--arch", "mamba2-1.3b", "--smoke", "--engine", "paged",
            "--requests", "6", "--max-len", "48"]
    jserve.main(argv)
    want = _lines(capsys.readouterr().out)
    _, jparams, cfg, params = _model("mamba2-1.3b")
    monkeypatch.setattr(serve.T, "init_params",
                        lambda c, g, d: params.to(d))
    serve.main(argv + ["--device", "cpu"])
    got = _lines(capsys.readouterr().out)
    assert got == want and any("peak pages" in line for line in got)


def test_launcher_exits_for_the_encoder_as_the_reference():
    for main in (jserve.main, serve.main):
        with pytest.raises(SystemExit, match="hubert-xlarge is encoder-only"):
            main(["--arch", "hubert-xlarge", "--smoke", "--engine", "dense"])


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "phi3.5-moe-42b-a6.6b",
                                  "jamba-1.5-large-398b", "mamba2-1.3b"])
def test_launcher_plan_prints_the_reference_s_lines(arch, capsys):
    argv = ["--arch", arch, "--plan"]
    jserve.main(argv)
    want = capsys.readouterr().out
    serve.main(argv)
    assert capsys.readouterr().out == want


# -- the paged step, shared with tests/test_torch_paged.py --------------------------


def _paged_pair(jcfg, jparams, cfg, params):
    """A chunk of 8 at starts 0 and 4, then a decode step of both rows at
    their own positions, against the reference's paged_step: logits
    within 1e-4 and every pool and slot-resident leaf equal."""
    jcache = JT.init_paged_cache(jcfg, 6, 4, 2)
    cache = T.init_paged_cache(cfg, 6, 4, 2, device="cpu")
    tables = np.array([[3, 1, 0, 0], [2, 5, 4, 0]], np.int32)
    rng = np.random.default_rng(3)
    toks = rng.integers(cfg.vocab_size, size=(2, 8)).astype(np.int32)
    steps = [(toks, np.array([0, 4], np.int32), np.array([8, 6], np.int32)),
             (toks[:, :1], np.array([8, 10], np.int32), None)]
    for tk, st, sl in steps:
        want, jcache = JT.paged_step(
            jparams, jcfg, jcache, jnp.asarray(tk), jnp.asarray(st),
            jnp.asarray(tables), jnp.arange(2, dtype=jnp.int32),
            None if sl is None else jnp.asarray(sl))
        got, cache = T.paged_step(
            params, cfg, cache, torch.from_numpy(tk), torch.from_numpy(st),
            torch.from_numpy(tables), torch.arange(2),
            None if sl is None else torch.from_numpy(sl))
        _close(got, want)
        _close_cache(cache, jcache, cfg)


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_paged_step_matches_jax(arch):
    _paged_pair(*_model(arch, lift=True))
