"""Flash attention: the Hopper port of the Pallas TPU kernel
``repro/kernels/flash_attention.py::_flash_kernel``.

The kernels are CUDA C++ in ``csrc/flash_attention.cu`` (its note gives
the bound and the design), built at first launch by :mod:`._build`. The
wrapper dispatches by the tensors' device: CPU tensors take
:func:`flash_attention_plain`, the same online-softmax arithmetic in plain
PyTorch. CUDA tensors take the kernel of their dtype (:func:`cuda_route`):
bfloat16 the tensor-core kernel (wgmma, TMA), float32 the f32 FMA kernel;
each launches or raises. Nothing falls back.

Layout, as in the JAX package: q ``(B·H, Sq, D)``; k, v ``(B·Hkv, Sk, D)``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches made by :func:`flash_attention` (the plain version and
#: CPU calls do not count); a caller resets it to 0 and reads it back
launches = 0
#: the same launches by route (:func:`reset_launches` zeroes both)
route_launches = {"bf16_wgmma": 0, "f32_fma": 0}
#: the route of each dtype: an explicit dispatch, never a fallback
ROUTES = {torch.bfloat16: "bf16_wgmma", torch.float32: "f32_fma"}

MAX_HEAD_DIM = 128
_NEG_BIG = -1e30
_lib: ctypes.CDLL | None = None


def kv_rows(bh: int, num_q_heads: int, num_kv_heads: int,
            device=None) -> torch.Tensor:
    """The k/v row of every q row: ``(b // H)·Hkv + (b % H) // (H/Hkv)``."""
    idx = torch.arange(bh, device=device)
    group = num_q_heads // num_kv_heads
    return (idx // num_q_heads) * num_kv_heads + (idx % num_q_heads) // group


def flash_attention_plain(q, k, v, *, num_q_heads: int, num_kv_heads: int,
                          causal: bool = True, scale: float | None = None,
                          block_k: int = 256) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: f32 online softmax over kv
    blocks of ``block_k``. All q rows go at once; a causal block wholly
    above a row's diagonal leaves its m, l and acc exactly as they were,
    which is what the kernel's block skip does."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = float(scale if scale is not None else d ** -0.5)
    rows = kv_rows(bh, num_q_heads, num_kv_heads, q.device)
    qf = q.float()
    kf = k.float()[rows]
    vf = v.float()[rows]
    m = torch.full((bh, sq, 1), _NEG_BIG, device=q.device)
    l = torch.zeros((bh, sq, 1), device=q.device)
    acc = torch.zeros((bh, sq, d), device=q.device)
    row_ids = torch.arange(sq, device=q.device)[:, None]
    for k0 in range(0, sk, block_k):
        kb, vb = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
        s = (qf @ kb.transpose(1, 2)) * scale
        if causal:
            mask = row_ids >= torch.arange(k0, k0 + kb.shape[1],
                                           device=q.device)[None, :]
            s = torch.where(mask, s, _NEG_BIG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        if causal:
            p = torch.where(mask, p, 0.0)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        m = m_new
        acc = acc * alpha + p @ vb
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def _library() -> ctypes.CDLL:
    """The library, its entries' types set and the bf16 route's tensor-map
    encoder handed in, once."""
    global _lib
    if _lib is None:
        lib = _build.library("flash_attention")
        for fn in (lib.repro_flash_attention_f32, lib.repro_flash_attention_bf16):
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        for fn, nargs in ((lib.repro_flash_attention_smem_bytes, 1),
                          (lib.repro_flash_bf16_warpgroups, 1),
                          (lib.repro_flash_bf16_smem_bytes, 2)):
            fn.argtypes = [ctypes.c_int] * nargs
            fn.restype = ctypes.c_int
        lib.repro_flash_set_encoder.argtypes = [ctypes.c_void_p]
        lib.repro_flash_set_encoder.restype = None
        libcuda = ctypes.CDLL("libcuda.so.1")
        lib.repro_flash_set_encoder(
            ctypes.cast(libcuda.cuTensorMapEncodeTiled, ctypes.c_void_p))
        _lib = lib
    return _lib


def reset_launches() -> None:
    """Set :data:`launches` and every count of :data:`route_launches` to 0."""
    global launches
    launches = 0
    for route in route_launches:
        route_launches[route] = 0


def cuda_route(q, k, v) -> str:
    """The kernel a CUDA call takes, by dtype: ``"bf16_wgmma"`` (tensor
    cores) or ``"f32_fma"`` (CUDA cores). Raises ``ValueError`` for what
    neither takes. Shapes must already agree (:func:`flash_attention`
    checks them first)."""
    if q.shape[2] > MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[2]} above the kernel's "
                         f"{MAX_HEAD_DIM}")
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"kernel takes float32 or bfloat16 alike, not "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("kernel takes contiguous q, k, v")
    return ROUTES[q.dtype]


def _tma_operand(t: torch.Tensor, d8: int) -> torch.Tensor:
    """``t`` as the bf16 route's tensor maps take it: rows of a multiple of
    8 elements (16 bytes; zero columns added, which change no score) and a
    16-byte aligned base."""
    if t.shape[2] != d8:
        t = torch.nn.functional.pad(t, (0, d8 - t.shape[2]))
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q, k, v, *, num_q_heads: int, num_kv_heads: int,
                    causal: bool = True, scale: float | None = None,
                    block_q: int = 256, block_k: int = 256) -> torch.Tensor:
    """q: (B·H, Sq, D); k/v: (B·Hkv, Sk, D) — GQA folded into the lead axis.

    ``block_q``/``block_k`` keep the Pallas kernel's contract: clamped to
    the sequence lengths, they must divide them or ``ValueError`` is
    raised, on every device. The CUDA kernels tile by their own 64 rows.

    There is no backward kernel (the reference's Pallas kernel has no
    ``custom_vjp`` either): under grad mode, an input that requires grad
    raises ``RuntimeError`` on every device, where the kernel's output
    would carry no ``grad_fn`` and cut attention out of the gradient."""
    global launches
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward: it cannot take inputs that "
            "require grad under grad mode; train with attention_impl="
            "'ref' or 'chunked', or call it under torch.no_grad()")
    bh, sq, d = q.shape
    bhkv, sk, _ = k.shape
    if num_q_heads % num_kv_heads or bh % num_q_heads:
        raise ValueError(f"{bh} q rows do not fold {num_q_heads} heads "
                         f"over {num_kv_heads} kv heads")
    if bhkv != bh // num_q_heads * num_kv_heads or v.shape != k.shape \
            or k.shape[2] != d:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    block_q = min(block_q, sq)
    block_k = min(block_k, sk)
    if sq % block_q or sk % block_k:
        raise ValueError(f"seq ({sq},{sk}) not divisible by blocks "
                         f"({block_q},{block_k})")
    scale = float(scale if scale is not None else d ** -0.5)
    kinds = {q.device.type, k.device.type, v.device.type}
    if kinds == {"cpu"}:
        return flash_attention_plain(q, k, v, num_q_heads=num_q_heads,
                                     num_kv_heads=num_kv_heads, causal=causal,
                                     scale=scale, block_k=block_k)
    if kinds != {"cuda"} or not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on mixed devices: {q.device}, "
                         f"{k.device}, {v.device}")
    route = cuda_route(q, k, v)
    lib = _library()
    if route == "bf16_wgmma":
        if scale < 0:       # the kernel's row max is over unscaled q·k
            q, scale = -q, -scale
        d8 = -(-d // 8) * 8
        q, k, v = (_tma_operand(t, d8) for t in (q, k, v))
        o = torch.empty_like(q)
        err = _build.launch(lib.repro_flash_attention_bf16, q.device,
                            q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), bh, num_q_heads, num_kv_heads, sq,
                            sk, d8, int(causal), scale)
        if err < 0:
            raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled "
                               f"returned CUresult {-err}")
        if d8 != d:
            o = o[..., :d].contiguous()
    else:
        o = torch.empty_like(q)
        err = _build.launch(lib.repro_flash_attention_f32, q.device,
                            q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), bh, num_q_heads, num_kv_heads, sq,
                            sk, d, int(causal), scale)
    _build.check(lib, err, "flash_attention")
    launches += 1
    route_launches[route] += 1
    return o
