"""The port's transformer against the JAX reference on the CPU: the dense
family here, the other families in tests/test_torch_families.py.

Weights come from the JAX package's ``init_params`` and are carried
across by ``params_from_jax``; tokens are made with numpy from a seed and
handed to both sides. Tolerance 1e-4 in float32: the two sides do the
same arithmetic and differ only in the order of summation.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax

TOL = 1e-4
PORTED = tuple(jconfigs.list_archs())


@pytest.fixture(scope="module")
def granite():
    jcfg = jconfigs.get_smoke_config("granite-8b")
    jparams = JT.init_params(jcfg, jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              configs.get_smoke_config("granite-8b"))
    return jcfg, jparams, tparams


def _close(t, j):
    np.testing.assert_allclose(t.detach().cpu().float().numpy(),
                               np.asarray(j, np.float32), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", PORTED)
def test_configs_copy_field_by_field(arch):
    assert (dataclasses.asdict(configs.get_config(arch))
            == dataclasses.asdict(jconfigs.get_config(arch)))
    assert (dataclasses.asdict(configs.get_smoke_config(arch))
            == dataclasses.asdict(jconfigs.get_smoke_config(arch)))


def test_unported_arch_raises_keyerror():
    """Every arch of the reference resolves, in its order; only a name
    the reference does not know raises."""
    assert configs.list_archs() == jconfigs.list_archs()
    for arch in jconfigs.list_archs():
        assert configs.get_config(arch).name == arch
    for get in (configs.get_config, configs.get_smoke_config):
        with pytest.raises(KeyError, match="unknown arch"):
            get("gpt-5")


def test_params_from_jax_takes_bfloat16():
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("granite-8b"),
                               param_dtype="bfloat16", dtype="bfloat16")
    jparams = JT.init_params(jcfg, jax.random.key(1))
    tparams = params_from_jax(
        jax.tree.map(np.asarray, jparams),
        dataclasses.replace(configs.get_smoke_config("granite-8b"),
                            param_dtype="bfloat16", dtype="bfloat16"))
    wq = tparams.blocks[1]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.float().numpy(), np.asarray(jparams["units"]["b0"]["wq"][1],
                                       np.float32))


@pytest.mark.parametrize("impl", ["ref", "flash"])
def test_prefill_and_decode_match_jax(granite, impl):
    jcfg, jparams, tparams = granite
    jcfg = dataclasses.replace(jcfg, attention_impl=impl)
    cfg = dataclasses.replace(configs.get_smoke_config("granite-8b"),
                              attention_impl=impl)
    rng = np.random.default_rng(0)
    b, s, max_len = 2, 16, 24
    prompt = rng.integers(cfg.vocab_size, size=(b, s)).astype(np.int32)

    jlogits, jcache = JT.prefill(jparams, jcfg, {"tokens": jnp.asarray(prompt)},
                                 max_len=max_len)
    logits, cache = T.prefill(tparams, cfg,
                              {"tokens": torch.as_tensor(prompt).long()},
                              max_len=max_len)
    assert logits.shape == (b, 1, cfg.vocab_size)
    _close(logits, jlogits)
    for name in ("k", "v"):
        _close(cache[name], jcache["b0"][name])

    # three decode steps: scalar positions, then per-slot vector positions
    for step in range(3):
        toks = rng.integers(cfg.vocab_size, size=(b, 1)).astype(np.int32)
        if step < 2:
            jidx, idx = jnp.int32(s + step), s + step
        else:
            pos = np.array([s + step, s + step - 1], np.int32)
            jidx, idx = jnp.asarray(pos), torch.as_tensor(pos)
        jlogits, jcache = JT.decode(jparams, jcfg, jcache, jnp.asarray(toks),
                                    jidx)
        logits, cache = T.decode(tparams, cfg, cache,
                                 torch.as_tensor(toks).long(), idx)
        _close(logits, jlogits)
        for name in ("k", "v"):
            _close(cache[name], jcache["b0"][name])


def test_flash_and_ref_agree_in_the_port(granite):
    _, _, tparams = granite
    cfg = configs.get_smoke_config("granite-8b")
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        cfg.vocab_size, size=(1, 32))).long()
    ref, _ = T.prefill(tparams, cfg, {"tokens": toks})
    flash, _ = T.prefill(tparams, dataclasses.replace(
        cfg, attention_impl="flash"), {"tokens": toks})
    torch.testing.assert_close(flash, ref, atol=TOL, rtol=TOL)


def test_init_params_laws_and_device():
    cfg = configs.get_smoke_config("granite-8b")
    p = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert p.embed.shape == (cfg.vocab_size, cfg.d_model)
    assert len(p.blocks) == cfg.num_layers
    w = p.blocks[0]["w_down"]
    assert w.shape == (cfg.d_ff, cfg.d_model)
    assert abs(w.std().item() - cfg.d_ff ** -0.5) < 0.1 * cfg.d_ff ** -0.5
    assert torch.equal(p.blocks[1]["attn_norm"], torch.ones(cfg.d_model))
    assert not any(t.requires_grad for t in p.parameters())


def test_unported_paths_raise():
    """The paged int8 cache raises as the reference's does
    (repro/models/transformer.py:276-278), and MLA under flash raises
    ``ValueError``: q is 24 wide and v 16 at the smoke size (192 and 128
    at full width), which the kernel's layout cannot take."""
    cfg = configs.get_smoke_config("granite-8b")
    int8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    with pytest.raises(NotImplementedError, match="not paged yet"):
        T.init_paged_cache(int8, 4, 4, 1, "cpu")
    with pytest.raises(NotImplementedError, match="not paged yet"):
        JT.init_paged_cache(dataclasses.replace(
            jconfigs.get_smoke_config("granite-8b"), kv_cache_dtype="int8"),
            4, 4, 1)
    mla = dataclasses.replace(configs.get_smoke_config("deepseek-v2-lite-16b"),
                              attention_impl="flash")
    p = T.init_params(mla, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="do not match q"):
        T.prefill(p, mla, {"tokens": torch.zeros((1, 4), dtype=torch.long)})
