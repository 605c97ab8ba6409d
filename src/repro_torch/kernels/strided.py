"""Strided shared-memory gather, the bank-conflict probe: the Hopper port
of the Pallas TPU kernel ``repro/kernels/strided.py::_strided_kernel``
(paper §6.2, Listing 4, Table 8).

The kernel is CUDA C++ in ``csrc/strided.cu`` (its note gives the bound
and the design): one CTA stages ``x`` in shared memory with 16-byte
loads, the 32 lanes of a warp read rows ``(i·stride) % n`` one column at
a time (Listing 4's pattern), and a transpose in registers makes every
warp store write one output row's consecutive units. The wrapper
dispatches by the tensor's device: CPU tensors take
:func:`strided_gather_plain`; CUDA tensors launch the kernel or raise, and
raise ``ValueError`` when ``x`` does not fit in one CTA's shared memory.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches made by :func:`strided_gather` (the plain version and
#: CPU calls do not count); a caller resets it to 0 and reads it back
launches = 0

_lib: ctypes.CDLL | None = None
_max_smem = 0                 # bytes of shared memory one CTA may hold


def _library() -> ctypes.CDLL:
    global _lib, _max_smem
    if _lib is None:
        lib = _build.library("strided")
        lib.repro_strided_gather.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.repro_strided_gather.restype = ctypes.c_int
        lib.repro_strided_max_smem.argtypes = []
        lib.repro_strided_max_smem.restype = ctypes.c_int
        _max_smem = lib.repro_strided_max_smem()
        _lib = lib
    return _lib


def gather_index(n: int, stride: int, device=None) -> torch.Tensor:
    return (torch.arange(n, device=device) * stride) % n


def strided_gather_plain(x: torch.Tensor, *, stride: int) -> torch.Tensor:
    return x.index_select(0, gather_index(x.shape[0], stride, x.device))


def unit_bytes(row_bytes: int, *pointers: int) -> int:
    """The widest unit, 4, 2 or 1 bytes, that divides the row and every
    pointer: the kernel moves rows in units of it."""
    bits = row_bytes
    for p in pointers:
        bits |= p
    return 4 if bits % 4 == 0 else 2 if bits % 2 == 0 else 1


def strided_gather(x: torch.Tensor, *, stride: int) -> torch.Tensor:
    """out[i] = x[(i * stride) % n] over the leading axis, in one block."""
    global launches
    if x.dim() == 0 or x.shape[0] == 0:
        raise ValueError(f"strided_gather needs rows, not {tuple(x.shape)}")
    if x.device.type == "cpu":
        return strided_gather_plain(x, stride=stride)
    if x.device.type != "cuda":
        raise ValueError(f"strided_gather takes CPU or CUDA tensors, "
                         f"not {x.device}")
    if not x.is_contiguous():
        x = x.contiguous()
    out = torch.empty_like(x)
    n = x.shape[0]
    row_bytes = x.numel() // n * x.element_size()
    if row_bytes == 0:
        return out
    unit = unit_bytes(row_bytes, x.data_ptr(), out.data_ptr())
    w = row_bytes // unit
    lib = _library()
    smem = n * (w + 1) * unit
    if smem > _max_smem:
        raise ValueError(f"x {tuple(x.shape)} {x.dtype} needs {smem} bytes of "
                         f"shared memory, above one CTA's {_max_smem}")
    err = _build.launch(lib.repro_strided_gather, x.device, x.data_ptr(),
                        out.data_ptr(), n, w, unit, stride % n)
    _build.check(lib, err, "strided_gather")
    launches += 1
    return out
