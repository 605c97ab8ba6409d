"""Fused RMSNorm: the Hopper port of the Pallas TPU kernel
``repro/kernels/rmsnorm.py::_rmsnorm_kernel``.

The kernel is CUDA C++ in ``csrc/rmsnorm.cu`` (its note gives the bound
and the design), built at first launch by :mod:`._build`. The wrapper
keeps the Pallas contract: ``x`` is ``(rows, d)``, ``scale`` is ``(d,)``,
``block_rows`` is clamped to ``rows`` and must divide it (``ValueError``
otherwise, on every device). It dispatches by the tensor's device: CPU
tensors take :func:`repro_torch.kernels.ref.rmsnorm_ref`; CUDA tensors
launch the kernel or raise. Nothing falls back.

The model does not call it: the JAX model normalises with
``layers.rms_norm``, whose rounding order differs (ROADMAP.md, queue 3).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

#: kernel launches made by :func:`rmsnorm` (CPU calls do not count); a
#: caller resets it to 0 and reads it back
launches = 0

_lib: ctypes.CDLL | None = None

#: the C interface's dtype codes
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.library("rmsnorm")
        lib.repro_rmsnorm.argtypes = ([ctypes.c_void_p] * 3
                                      + [ctypes.c_int] * 4
                                      + [ctypes.c_float, ctypes.c_void_p])
        lib.repro_rmsnorm.restype = ctypes.c_int
        lib.repro_rmsnorm_vector_path.argtypes = [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        lib.repro_rmsnorm_vector_path.restype = ctypes.c_int
        _lib = lib
    return _lib


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
            block_rows: int = 256) -> torch.Tensor:
    """x: (rows, d); scale: (d,). Returns x's type and shape."""
    global launches
    if x.dim() != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"expected x (rows, d) and scale (d,), not "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    rows, d = x.shape
    block_rows = min(block_rows, rows)
    if rows % block_rows:
        raise ValueError(f"rows={rows} % block_rows={block_rows} != 0")
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps=eps)
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm takes x and scale on one CUDA card or on "
                         f"the CPU, not {x.device} and {scale.device}")
    if x.dtype not in _DTYPE_CODES or scale.dtype not in _DTYPE_CODES:
        raise ValueError(f"rmsnorm takes float32 or bfloat16, not {x.dtype} "
                         f"and {scale.dtype}")
    x, scale = x.contiguous(), scale.contiguous()
    out = torch.empty_like(x)
    lib = _library()
    err = _build.launch(
        lib.repro_rmsnorm, x.device, x.data_ptr(), scale.data_ptr(),
        out.data_ptr(), rows, d, _DTYPE_CODES[x.dtype],
        _DTYPE_CODES[scale.dtype], eps)
    _build.check(lib, err, "rmsnorm")
    launches += 1
    return out


def vector_path(x: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether the kernel takes its register-held vector path for these
    tensors (else the scalar one, which reads each row twice)."""
    return bool(_library().repro_rmsnorm_vector_path(
        x.data_ptr(), out.data_ptr(), x.shape[1], _DTYPE_CODES[x.dtype]))
