"""The routes of the port's flash attention and strided gather.

Flash attention dispatches CUDA tensors by dtype: bfloat16 to the
tensor-core kernel (wgmma, TMA), float32 to the f32 FMA kernel, anything
else to ``ValueError``; CPU tensors take the plain version and count no
launch. The strided gather moves rows in the widest unit (4, 2 or 1
bytes) that divides them. On the CPU these tests hold the Python around
the kernels (the dispatch, the rejections, the tensor-map operands, the
unit choice) and the plain versions to the JAX package at the serving
path's ragged lengths; the tests marked ``gpu`` take the float32 route
and hold the strided gather to its plain version on the card, and skip
without one (``tests/test_torch_kernels.py`` holds both flash routes to
the plain version at every shape the card times).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels import strided as st
from repro_torch.kernels.ref import FLASH_TILE_REL_RMS_TOL, TOL


def _inputs(bh, bhkv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bh, sq, d), np.float32),
            rng.standard_normal((bhkv, sk, d), np.float32),
            rng.standard_normal((bhkv, sk, d), np.float32))


# -- on the CPU ------------------------------------------------------------------


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "bf16_wgmma"),
                                         (torch.float32, "f32_fma")])
def test_cuda_route_by_dtype(dtype, route):
    q = torch.zeros((4, 16, 64), dtype=dtype)
    assert fa.cuda_route(q, q, q) == route == fa.ROUTES[dtype]


@pytest.mark.parametrize("case", ["float16", "mixed dtypes", "head dim 136",
                                  "not contiguous"])
def test_cuda_route_rejects(case):
    q = torch.zeros((4, 16, 64), dtype=torch.bfloat16)
    k = v = q
    if case == "float16":
        q = k = v = q.half()
    elif case == "mixed dtypes":
        k = q.float()
    elif case == "head dim 136":
        q = k = v = torch.zeros((4, 16, 136), dtype=torch.bfloat16)
    else:
        q = torch.zeros((4, 64, 16), dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError):
        fa.cuda_route(q, k, v)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    arrays = _inputs(4, 1, 101, 101, 32)
    fa.reset_launches()
    got = fa.flash_attention(*(torch.from_numpy(a).bfloat16()
                               for a in arrays),
                             num_q_heads=4, num_kv_heads=1, block_q=101,
                             block_k=101)
    assert got.dtype == torch.bfloat16
    assert fa.launches == 0
    assert fa.route_launches == {"bf16_wgmma": 0, "f32_fma": 0}


def test_reset_launches():
    fa.launches = 3
    fa.route_launches["bf16_wgmma"] = 2
    fa.route_launches["f32_fma"] = 1
    fa.reset_launches()
    assert fa.launches == 0 and set(fa.route_launches.values()) == {0}


@pytest.mark.parametrize("d,d8", [(128, 128), (100, 104), (36, 40), (8, 8)])
def test_tma_operand_pads_rows_to_16_bytes(d, d8):
    t = torch.randn((2, 5, d)).bfloat16()
    got = fa._tma_operand(t, d8)
    assert got.shape == (2, 5, d8) and got.data_ptr() % 16 == 0
    assert torch.equal(got[..., :d], t)
    assert not got[..., d:].any()
    assert (got is t) == (d == d8)


def test_tma_operand_realigns_an_offset_view():
    base = torch.zeros(2 * 5 * 64 + 1, dtype=torch.bfloat16)
    t = base[1:].view(2, 5, 64)
    assert t.is_contiguous() and t.data_ptr() % 16
    got = fa._tma_operand(t, 64)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, t)


@pytest.mark.parametrize("bh,h,hkv,s", [(8, 4, 1, 101), (4, 4, 2, 37),
                                        (2, 2, 2, 255)])
def test_plain_matches_pallas_at_ragged_lengths(bh, h, hkv, s):
    """The dense engine's prompts are 4-255 tokens: one block of the whole
    length on both sides, bf16, head dim 128."""
    arrays = _inputs(bh, bh // h * hkv, s, s, 128, seed=s)
    kw = dict(num_q_heads=h, num_kv_heads=hkv, causal=True, block_q=s,
              block_k=s)
    want = jops.flash_attention(*(jnp.asarray(a, jnp.bfloat16)
                                  for a in arrays), interpret=True, **kw)
    got = fa.flash_attention(*(torch.from_numpy(a).bfloat16()
                               for a in arrays), **kw)
    tol = TOL[torch.bfloat16]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    assert ref.tile_rel_rms(got, torch.from_numpy(
        np.asarray(want, np.float32))) < FLASH_TILE_REL_RMS_TOL


def _bf16_rounding_of_the_kernel(q, k, v, h, hkv, causal):
    """What the bf16 route computes, in plain PyTorch: f32 scores and
    softmax, P rounded to bf16 for P·V, the sum over f32 P, one cast."""
    rows = fa.kv_rows(q.shape[0], h, hkv)
    kf, vf = k.float()[rows], v.float()[rows]
    s = q.float() @ kf.transpose(1, 2) * q.shape[2] ** -0.5
    if causal:
        keep = torch.ones(s.shape[1:], dtype=torch.bool).tril()
        s = s.masked_fill(~keep, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = p.bfloat16().float() @ vf / p.sum(-1, keepdim=True)
    return o.bfloat16()


@pytest.mark.parametrize("bh,h,hkv,s", [(4, 4, 1, 101), (4, 4, 2, 256),
                                        (2, 2, 1, 640)])
def test_tile_gate_passes_bf16_rounding_and_fails_a_skipped_kv_tile(
        bh, h, hkv, s):
    """The bf16 flash tile gate sits between the rounding the kernel
    does and a kernel that skips the first head's last kv tile."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _inputs(bh, bh // h * hkv, s, s, 128, seed=s))
    kw = dict(num_q_heads=h, num_kv_heads=hkv, causal=True)
    want = fa.flash_attention_plain(q, k, v, **kw)
    rounded = _bf16_rounding_of_the_kernel(q, k, v, h, hkv, True)
    assert ref.tile_rel_rms(rounded, want) < FLASH_TILE_REL_RMS_TOL / 2
    cut = (s - 1) // 64 * 64
    faulted = want.clone()
    faulted[0] = fa.flash_attention_plain(q, k[:, :cut], v[:, :cut], **kw)[0]
    assert ref.tile_rel_rms(faulted, want) > 5 * FLASH_TILE_REL_RMS_TOL


@pytest.mark.parametrize("s,tile", [(64, 0), (100, 1), (130, 0), (130, 2)])
def test_tile_rel_rms_reads_each_tile_alone(s, tile):
    rng = np.random.default_rng(s)
    want = torch.from_numpy(rng.standard_normal((3, s, 8), np.float32))
    assert ref.tile_rel_rms(want.clone(), want) == 0.0
    got = want.clone()
    got[1, 64 * tile:64 * tile + 64] *= 1.25
    assert ref.tile_rel_rms(got, want) == pytest.approx(0.25, rel=1e-5)


@pytest.mark.parametrize("row_bytes,ptrs,unit", [
    (1024, (0, 256), 4), (510, (0, 256), 2), (255, (0, 256), 1),
    (1024, (2, 256), 2), (1024, (0, 1), 1), (12, (), 4)])
def test_strided_unit_choice(row_bytes, ptrs, unit):
    assert st.unit_bytes(row_bytes, *ptrs) == unit


# -- on the card -------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch sees no CUDA device)")


@pytest.mark.gpu
def test_f32_takes_its_own_route_on_card():
    _card()
    q, k, v = (torch.from_numpy(a).cuda() for a in _inputs(8, 2, 64, 64, 32))
    fa.reset_launches()
    got = fa.flash_attention(q, k, v, num_q_heads=4, num_kv_heads=1)
    torch.cuda.synchronize()
    assert fa.route_launches == {"bf16_wgmma": 0, "f32_fma": 1}
    want = fa.flash_attention_plain(q, k, v, num_q_heads=4, num_kv_heads=1)
    torch.testing.assert_close(got, want, atol=TOL[torch.float32],
                               rtol=TOL[torch.float32])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), k.half(), v.half(), num_q_heads=4,
                           num_kv_heads=1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,cols,unit", [(torch.float32, 256, 4),
                                             (torch.bfloat16, 255, 2),
                                             (torch.int8, 255, 1)])
@pytest.mark.parametrize("n", [32, 64, 128])
def test_strided_exact_every_stride_on_card(n, dtype, cols, unit):
    _card()
    g = torch.Generator(device="cuda").manual_seed(n)
    x = (torch.randn((n, cols), generator=g, device="cuda") * 50).to(dtype)
    out = torch.empty_like(x)
    assert st.unit_bytes(cols * x.element_size(), x.data_ptr(),
                         out.data_ptr()) == unit
    for stride in range(1, 258):
        assert torch.equal(st.strided_gather(x, stride=stride),
                           st.strided_gather_plain(x, stride=stride))


@pytest.mark.gpu
def test_strided_exact_every_stride_at_the_curve_shape_on_card():
    """(1024, 32) float32, the stride curve whose conflicts reach 32-way."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(1024)
    x = torch.randn((1024, 32), generator=g, device="cuda")
    for stride in range(1, 258):
        assert torch.equal(st.strided_gather(x, stride=stride),
                           st.strided_gather_plain(x, stride=stride))
