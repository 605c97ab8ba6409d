"""Paged decode attention: one query a row against its own pages of a
paged KV pool, read where they lie through the page table.

It replaces no TPU kernel: the JAX package's paged path gathers each
slot's whole page-table row and attends through the masked plain branch
(``repro/models/layers.py``), with no ``pallas_call``. The kernel is CUDA
C++ in ``csrc/paged_decode.cu`` (its note gives the bound and the design),
built at first launch by :mod:`._build`. The wrapper dispatches by the
tensors' device: CPU (and meta) tensors take :func:`paged_decode_plain`,
the gather and masked softmax of the plain branch; CUDA tensors launch
the kernel or raise. Nothing falls back.

Layout: q ``(B, 1, H, D)``; the pools ``(num_pages, page_len, Hkv, D)``;
``page_table`` ``(B, P)``; ``positions`` ``(B, 1)``, the position each
row's query stands at (it sees ``0 .. positions[b]``). A row whose first
table entry is page 0, the engine's scratch page, is idle: it reads
nothing and its output is zeros.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches made by :func:`paged_decode_attention` (the plain
#: version and CPU calls do not count); a caller resets it to 0
launches = 0
#: positions a split of a row covers, at least: a whole number of pages
SPLIT_POSITIONS = 256
MAX_HEAD_DIM = 128
MAX_GROUP = 16
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    global launches
    launches = 0


def split_len(page_len: int) -> int:
    """Positions a work item covers: the fewest whole pages that reach
    :data:`SPLIT_POSITIONS`."""
    return -(-SPLIT_POSITIONS // page_len) * page_len


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float64 else x.float()


def paged_decode_plain(q, k_pages, v_pages, page_table, positions, *,
                       scale: float | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, as the plain branch of
    ``models.layers._sdpa`` computes it over ``_paged_gather``'s rows: f32
    scores scaled after the product, positions past each row's own set to
    -1e30, softmax, f32 P·V, one cast; idle rows zeros."""
    b, s, h, d = q.shape
    num_pages, page_len, hkv, _ = k_pages.shape
    t = page_table.shape[1] * page_len
    kg = k_pages[page_table].reshape(b, t, hkv, d)
    vg = v_pages[page_table].reshape(b, t, hkv, d)
    valid = (torch.arange(t, device=q.device)[None, None, :]
             <= positions.reshape(b, s)[:, :, None])
    qg = q.reshape(b, s, hkv, h // hkv, d)
    scale = d ** -0.5 if scale is None else scale
    scores = torch.einsum("bskgd,btkd->bkgst", _wide(qg), _wide(kg)) * scale
    scores = torch.where(valid[:, None, None, :, :], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, _wide(vg))
    o = o.reshape(b, s, h, d).to(q.dtype)
    return o.masked_fill((page_table[:, 0] == 0)[:, None, None, None], 0)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.library("paged_decode")
        lib.repro_paged_decode.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.repro_paged_decode.restype = ctypes.c_int
        lib.repro_paged_decode_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.repro_paged_decode_smem_bytes.restype = ctypes.c_longlong
        lib.repro_paged_decode_ctas_per_sm.argtypes = [ctypes.c_int] * 5
        lib.repro_paged_decode_ctas_per_sm.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q, k_pages, v_pages, page_table, positions) -> None:
    """Shapes, on every device."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, D), not {tuple(q.shape)}")
    b, _, h, d = q.shape
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape \
            or k_pages.shape[3] != d:
        raise ValueError(f"pools {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    hkv = k_pages.shape[2]
    if h % hkv:
        raise ValueError(f"{h} query heads do not fold over {hkv} KV heads")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or positions.numel() != b:
        raise ValueError(f"page_table {tuple(page_table.shape)} and "
                         f"positions {tuple(positions.shape)} do not match "
                         f"{b} rows")


def paged_decode_attention(q, k_pages, v_pages, page_table, positions, *,
                           scale: float | None = None) -> torch.Tensor:
    """q (B, 1, H, D) against the pools (num_pages, page_len, Hkv, D)
    through ``page_table`` (B, P), each row up to ``positions[b]``.
    Returns (B, 1, H, D) of q's type.

    There is no backward kernel: under grad mode, an input that requires
    grad raises ``RuntimeError`` on every device."""
    global launches
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_pages, v_pages)):
        raise RuntimeError("paged_decode_attention has no backward: call "
                           "it under torch.no_grad()")
    _check(q, k_pages, v_pages, page_table, positions)
    tensors = (q, k_pages, v_pages, page_table, positions)
    if not any(t.device.type == "cuda" for t in tensors):
        return paged_decode_plain(q, k_pages, v_pages, page_table, positions,
                                  scale=scale)
    dev = q.device
    if any(t.device != dev for t in tensors):
        raise ValueError("q, the pools, page_table and positions on mixed "
                         "devices: " + ", ".join(str(t.device)
                                                 for t in tensors))
    b, _, h, d = q.shape
    num_pages, page_len, hkv, _ = k_pages.shape
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"kernel takes float32 or bfloat16 alike, not "
                         f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} above the kernel's {MAX_HEAD_DIM}")
    if h // hkv > MAX_GROUP:
        raise ValueError(f"GQA group {h // hkv} above the kernel's "
                         f"{MAX_GROUP}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("kernel takes contiguous pools")
    q = q.contiguous()
    page_table = page_table.to(torch.long).contiguous()
    positions = positions.to(torch.long).reshape(b).contiguous()
    span = split_len(page_len)
    splits = -(-page_table.shape[1] * page_len // span)
    g = h // hkv
    out = torch.empty_like(q)
    part = torch.empty(b * hkv * splits * g * (d + 2), dtype=torch.float32,
                       device=dev)
    vec = int(d * q.element_size() % 16 == 0
              and k_pages.data_ptr() % 16 == 0
              and v_pages.data_ptr() % 16 == 0)
    lib = _library()
    err = _build.launch(
        lib.repro_paged_decode, dev, q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), page_table.data_ptr(), positions.data_ptr(),
        out.data_ptr(), part.data_ptr(), b, h, hkv, d, page_table.shape[1],
        page_len, span, _DTYPE_CODES[q.dtype],
        float(d ** -0.5 if scale is None else scale), vec)
    _build.check(lib, err, "paged_decode_attention")
    launches += 1
    return out


def launch_shape(q, k_pages) -> dict:
    """The split kernel's positions a work item, dynamic shared memory and
    CTAs an SM at these shapes (CUDA only; reported beside its times)."""
    b, _, h, d = q.shape
    _, page_len, hkv, _ = k_pages.shape
    lib = _library()
    args = (_DTYPE_CODES[q.dtype], h // hkv, d, b,
            split_len(page_len) // page_len)
    return {"split_positions": split_len(page_len),
            "smem_bytes": lib.repro_paged_decode_smem_bytes(*args),
            "ctas_per_sm": lib.repro_paged_decode_ctas_per_sm(*args)}
