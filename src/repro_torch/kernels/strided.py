"""Strided shared-memory gather, the bank-conflict probe: the Hopper port
of the Pallas TPU kernel ``repro/kernels/strided.py::_strided_kernel``
(paper §6.2, Listing 4, Table 8).

The kernel is CUDA C++ in ``csrc/strided.cu`` (its note gives the bound
and the design): one CTA stages ``x`` in shared memory and thread i
reads row ``(i·stride) % n``. The wrapper dispatches by the tensor's
device: CPU tensors take :func:`strided_gather_plain`; CUDA tensors
launch the kernel or raise, and raise ``ValueError`` when ``x`` does not
fit in one CTA's shared memory.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches made by :func:`strided_gather` (the plain version and
#: CPU calls do not count); a caller resets it to 0 and reads it back
launches = 0

_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.library("strided")
        lib.repro_strided_gather.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.repro_strided_gather.restype = ctypes.c_int
        lib.repro_strided_max_smem.argtypes = []
        lib.repro_strided_max_smem.restype = ctypes.c_int
        _lib = lib
    return _lib


def gather_index(n: int, stride: int, device=None) -> torch.Tensor:
    return (torch.arange(n, device=device) * stride) % n


def strided_gather_plain(x: torch.Tensor, *, stride: int) -> torch.Tensor:
    return x.index_select(0, gather_index(x.shape[0], stride, x.device))


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
    x = x.contiguous()
    out = torch.empty_like(x)
    n = x.shape[0]
    row_bytes = x[0].numel() * x.element_size()
    if row_bytes == 0:
        return out
    # the widest unit that divides the rows and the pointers
    unit = next(u for u in (4, 2, 1) if not (row_bytes % u or x.data_ptr() % u
                                             or out.data_ptr() % u))
    w = row_bytes // unit
    lib = _library()
    smem = n * (w + 1) * unit
    if smem > lib.repro_strided_max_smem():
        raise ValueError(f"x {tuple(x.shape)} {x.dtype} needs {smem} bytes of "
                         f"shared memory, above one CTA's "
                         f"{lib.repro_strided_max_smem()}")
    with torch.cuda.device(x.device):
        err = lib.repro_strided_gather(
            x.data_ptr(), out.data_ptr(), n, w, unit, stride % n,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "strided_gather")
    launches += 1
    return out
