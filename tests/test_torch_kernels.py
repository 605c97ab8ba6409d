"""The port's flash attention and rmsnorm against the JAX Pallas kernels.

On the CPU the port's wrapper runs its plain version; the JAX side runs
the Pallas kernel in interpret mode, as its own tests do. Inputs are made
with numpy from a seed. The flash shape matrix is that of
``tests/test_kernels.py::TestFlashAttention`` with S <= 512; tolerances
are the JAX package's own (2e-5 float32, 2e-2 bfloat16). The rmsnorm
matrix is that of ``tests/test_kernels_extra.py::TestRMSNormKernel``:
float32 within its 1e-6, and bfloat16 within its 2e-2 of the model's
``rms_norm`` and within one bfloat16 step of the Pallas output. The
tests marked ``gpu`` hold the CUDA kernels to their plain versions on
the card and skip without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rn

DTYPES = {"float32": (jnp.float32, torch.float32, ref.TOL[torch.float32]),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, ref.TOL[torch.bfloat16])}


def _inputs(batch, h, hkv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch * h, sq, d), np.float32),
            rng.standard_normal((batch * hkv, sk, d), np.float32),
            rng.standard_normal((batch * hkv, sk, d), np.float32))


def _run(batch, h, hkv, sq, sk, d, causal, dtype="float32", bq=128, bk=128):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs(batch, h, hkv, sq, sk, d)
    kw = dict(num_q_heads=h, num_kv_heads=hkv, causal=causal, block_q=bq,
              block_k=bk)
    want = jops.flash_attention(*(jnp.asarray(a, jdt) for a in arrays),
                                interpret=True, **kw)
    got = ops.flash_attention(*(torch.from_numpy(a).to(tdt) for a in arrays),
                              **kw)
    assert got.dtype == tdt and got.shape == (batch * h, sq, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha(causal, dtype):
    _run(2, 4, 4, 256, 256, 64, causal, dtype)


@pytest.mark.parametrize("h,hkv", [(8, 2), (4, 1), (16, 8)])
def test_gqa_ratios(h, hkv):
    _run(1, h, hkv, 256, 256, 64, True)


@pytest.mark.parametrize("bq,bk", [(64, 128), (128, 64), (256, 256),
                                   (64, 64)])
def test_block_shapes(bq, bk):
    _run(1, 2, 2, 256, 256, 64, True, bq=bq, bk=bk)


@pytest.mark.parametrize("causal", [True, False])
def test_rectangular_and_small_head_dim(causal):
    # causal with sq != sk pins the top-left aligned mask (row >= col)
    _run(1, 2, 1, 128, 512, 32, causal)


def test_head_dim_16_ragged_length():
    _run(2, 4, 2, 96, 96, 16, True, bq=96, bk=32)


def test_bad_divisibility_raises():
    q = torch.ones((2, 100, 64))
    with pytest.raises(ValueError, match="not divisible"):
        ops.flash_attention(q, q, q, num_q_heads=2, num_kv_heads=2,
                            block_q=64, block_k=64)


def test_attention_dispatch():
    q = torch.from_numpy(_inputs(1, 2, 2, 128, 128, 64, seed=3)[0])
    a = ops.attention(q, q, q, num_q_heads=2, num_kv_heads=2, impl="ref")
    b = ops.attention(q, q, q, num_q_heads=2, num_kv_heads=2,
                      impl="flash", block_q=64, block_k=64)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_jax_ref(causal):
    from repro.kernels import ref as jref
    arrays = _inputs(2, 8, 2, 64, 64, 32, seed=5)
    kw = dict(num_q_heads=8, num_kv_heads=2, causal=causal)
    want = jref.attention_ref(*(jnp.asarray(a) for a in arrays), **kw)
    got = ref.attention_ref(*(torch.from_numpy(a) for a in arrays), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_cpu_path_launches_nothing():
    before = fa.launches
    _run(1, 2, 2, 64, 64, 32, True, bq=64, bk=64)
    assert fa.launches == before


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    """Checked before any build or launch, so it runs without a card."""
    q = torch.zeros((2, 64, 16))
    with pytest.raises(ValueError, match="mixed devices"):
        ops.flash_attention(q, q.to("meta"), q, num_q_heads=2,
                            num_kv_heads=2)
    with pytest.raises(ValueError, match="do not match"):
        ops.flash_attention(q, q[:1], q, num_q_heads=2, num_kv_heads=2)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch sees no CUDA device)")


#: flash on the card, (batch, H, Hkv, sq, sk, D, causal): granite-8b's
#: heads at the serving path's lengths (the dense engine's prompts of
#: 4-255 tokens, the loop's 4 x 256) and beyond, a rectangular non-causal
#: case, the head dims (100 pads the bf16 route's operands to 104) and the
#: GQA ratios of tests/test_kernels.py at batch 1 and 2, hubert-xlarge's
#: forward (2 x 1024 frames, D 80, non-causal) and internvl2-2b's prefill
#: (4 x 512). chip_smoke.py times granite's heads at bh 32 x S 101, 256 and
#: 2,048 and bh 128 x S 256, and the last two.
CARD_CASES = {f"granite-S{s}": (1, 32, 8, s, s, 128, True)
              for s in (37, 101, 255, 256, 2048)}
CARD_CASES |= {"granite-bh128-S256": (4, 32, 8, 256, 256, 128, True),
               "granite-128x512-non-causal": (1, 32, 8, 128, 512, 128, False)}
CARD_CASES |= {f"D{d}": (1, 8, 8, 96, 96, d, True)
               for d in (16, 32, 64, 128, 100)}
CARD_CASES |= {f"GQA{h}/{hkv}-batch{b}": (b, h, hkv, 256, 256, 64, True)
               for h, hkv in ((8, 2), (4, 1), (16, 8)) for b in (1, 2)}
CARD_CASES |= {"hubert-xlarge": (2, 16, 16, 1024, 1024, 80, False),
               "internvl2-2b": (4, 16, 8, 512, 512, 128, True)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_matches_plain_on_card(dtype, case):
    """One launch on the dtype's route, within TOL of the plain version;
    bfloat16 also within the tile gate, which a kernel that skipped the
    first head's last kv tile would fail."""
    _card()
    batch, h, hkv, sq, sk, d, causal = CARD_CASES[case]
    _, tdt, tol = DTYPES[dtype]
    q, k, v = (torch.from_numpy(a).to("cuda", tdt)
               for a in _inputs(batch, h, hkv, sq, sk, d))
    kw = dict(num_q_heads=h, num_kv_heads=hkv, causal=causal)
    fa.reset_launches()
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.route_launches[fa.ROUTES[tdt]] == fa.launches == 1
    want = fa.flash_attention_plain(q, k, v, **kw)
    assert got.shape == want.shape and got.dtype == tdt
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if tdt != torch.bfloat16:
        return
    assert ref.tile_rel_rms(got, want) <= ref.FLASH_TILE_REL_RMS_TOL
    cut = (sk - 1) // 64 * 64
    if cut:
        faulted = want.clone()
        faulted[0] = fa.flash_attention_plain(q, k[:, :cut], v[:, :cut],
                                              **kw)[0]
        assert ref.tile_rel_rms(faulted, want) > ref.FLASH_TILE_REL_RMS_TOL


@pytest.mark.gpu
def test_kernel_rejects_on_card():
    _card()
    q = torch.zeros((2, 64, 256), device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q, num_q_heads=2, num_kv_heads=2)
    q = torch.zeros((2, 64, 64), device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2), q, q, num_q_heads=2,
                           num_kv_heads=2)
    q = torch.zeros((32, 300, 128), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not divisible"):
        fa.flash_attention(q, q[:8], q[:8], num_q_heads=32, num_kv_heads=8)


# -- rmsnorm -----------------------------------------------------------------

RMS_SHAPES = [(256, 128, 64), (512, 256, 256), (128, 512, 128)]


def _rms_inputs(rows, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, d), np.float32),
            (rng.standard_normal(d, np.float32) * 0.1 + 1).astype(np.float32))


@pytest.mark.parametrize("rows,d,block", RMS_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_pallas(rows, d, block, dtype):
    from repro.kernels.rmsnorm import rmsnorm as jrmsnorm
    from repro.models.layers import rms_norm as jrms_norm
    jdt, tdt, _ = DTYPES[dtype]
    x, sc = _rms_inputs(rows, d)
    jx, jsc = jnp.asarray(x, jdt), jnp.asarray(sc, jdt)
    want = jrmsnorm(jx, jsc, block_rows=block)
    before = rn.launches
    got = rn.rmsnorm(torch.from_numpy(x).to(tdt), torch.from_numpy(sc).to(tdt),
                     block_rows=block)
    assert rn.launches == before
    assert got.dtype == tdt and got.shape == (rows, d)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-6)
        return
    model = np.asarray(jrms_norm(jx, jsc, 1e-6), np.float32)
    np.testing.assert_allclose(got.float().numpy(), model, atol=2e-2,
                               rtol=2e-2)
    pallas = torch.from_numpy(np.asarray(want, np.float32)).to(torch.bfloat16)
    assert int(ref.bf16_ulp_distance(got, pallas).max()) <= 1


def test_rmsnorm_bad_block_raises():
    with pytest.raises(ValueError, match="block_rows"):
        rn.rmsnorm(torch.ones((100, 64)), torch.ones(64), block_rows=64)
    with pytest.raises(ValueError, match="scale"):
        rn.rmsnorm(torch.ones((64, 64)), torch.ones(32))


def test_bf16_ulp_distance():
    a = torch.tensor([1.0, -1.0, 0.0, 3.0], dtype=torch.bfloat16)
    b = torch.tensor([1.0078125, -1.0078125, -0.0, 3.0],
                     dtype=torch.bfloat16)
    assert ref.bf16_ulp_distance(a, b).tolist() == [1, 1, 0, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", [(8, 4096), (1024, 4096), (65536, 4096),
                                    (64, 12288), (32, 4100), (256, 4097)])
def test_rmsnorm_kernel_matches_plain_on_card(dtype, rows, d):
    """granite-8b's decode batch and prefill batch (4 x 256) at d 4,096
    and 65,536 rows of it (the two timed shapes), mistral-large-123b's d
    12,288, and widths that take
    the scalar tail; float32 within 1e-6 of the peak, bfloat16 within one
    step; rows that block_rows does not divide raise."""
    _card()
    _, tdt, _ = DTYPES[dtype]
    x, sc = (torch.from_numpy(a).to("cuda", tdt) for a in _rms_inputs(rows, d))
    before = rn.launches
    got = rn.rmsnorm(x, sc)
    torch.cuda.synchronize()
    assert rn.launches == before + 1
    want = ref.rmsnorm_ref(x, sc)
    if dtype == "float32":
        assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()
    else:
        assert int(ref.bf16_ulp_distance(got, want).max()) <= 1
    with pytest.raises(ValueError, match="block_rows"):
        rn.rmsnorm(x[:rows - 1], sc, block_rows=rows // 2)
