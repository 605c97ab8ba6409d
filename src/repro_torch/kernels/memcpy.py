"""Streaming copy: the Hopper port of the Pallas TPU kernel
``repro/kernels/memcpy.py::_memcpy_kernel`` (paper §5.1, Table 6).

The kernel is CUDA C++ in ``csrc/memcpy.cu`` (its note gives the bound
and the design), built at first launch by :mod:`._build`. The wrapper
keeps the Pallas contract, a ``(rows, cols)`` array whose rows
``block_rows`` divides, and dispatches by the tensor's device: CPU
tensors take :func:`memcpy_plain`; CUDA tensors launch the kernel or
raise. Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches made by :func:`memcpy` (the plain version and CPU calls
#: do not count); a caller resets it to 0 and reads it back
launches = 0

_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.library("memcpy")
        lib.repro_memcpy.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_longlong, ctypes.c_void_p]
        lib.repro_memcpy.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_blocks(x: torch.Tensor, block_rows: int) -> None:
    """The Pallas tiling contract: ``(rows, cols)`` with ``block_rows``
    dividing ``rows``; ``ValueError`` otherwise, on every device."""
    if x.dim() != 2:
        raise ValueError(f"expected a (rows, cols) array, not {tuple(x.shape)}")
    rows = x.shape[0]
    if block_rows <= 0 or rows % block_rows:
        raise ValueError(f"rows={rows} not divisible by block_rows={block_rows}")


def memcpy_plain(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def memcpy(x: torch.Tensor, *, block_rows: int = 256) -> torch.Tensor:
    """Copy a (rows, cols) array; ``block_rows`` must divide ``rows``."""
    global launches
    _check_blocks(x, block_rows)
    if x.device.type == "cpu":
        return memcpy_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"memcpy takes CPU or CUDA tensors, not {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    lib = _library()
    err = _build.launch(lib.repro_memcpy, x.device, x.data_ptr(),
                        out.data_ptr(), x.numel() * x.element_size())
    _build.check(lib, err, "memcpy")
    launches += 1
    return out
