"""Multi-buffered copy, Little's law made explicit: the Hopper port of the
Pallas TPU kernel ``repro/kernels/dbuf_copy.py::_dbuf_kernel`` (paper
§5.1, Fig 12).

The kernel is CUDA C++ in ``csrc/dbuf_copy.cu``: TMA bulk copies through
``num_buffers`` shared-memory stages of 24 KB, one pipeline on each SM,
whose tiles are claimed one at a time from a counter that this wrapper
keeps (its note gives the bound and the design). Any start is copied: a
source that is not 16-byte aligned is loaded by aligned spans and stored
shifted, in the same one launch. ``num_buffers`` is the
depth in flight on each SM. The wrapper keeps the Pallas ``block_rows``
contract and dispatches by the tensor's device: CPU tensors take
:func:`dbuf_copy_plain`; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches made by :func:`dbuf_copy` (the plain version and CPU
#: calls do not count); a caller resets it to 0 and reads it back
launches = 0

_lib: ctypes.CDLL | None = None
#: the kernel's tile counters, one per (device, stream): zeroed once here,
#: each launch claims its tiles from it and leaves it at zero
_counters: dict[tuple[int, int], torch.Tensor] = {}
#: each device's SM count, read once (one pipeline an SM)
_sms: dict[int, int] = {}


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.library("dbuf_copy")
        lib.repro_dbuf_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_void_p]
        lib.repro_dbuf_copy.restype = ctypes.c_int
        for fn in ("repro_dbuf_max_buffers", "repro_dbuf_tile_bytes"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_blocks(x: torch.Tensor, block_rows: int) -> None:
    """The Pallas contract and its message, on every device."""
    if x.dim() != 2:
        raise ValueError(f"expected a (rows, cols) array, not {tuple(x.shape)}")
    rows = x.shape[0]
    if block_rows <= 0 or rows % block_rows:
        raise ValueError(f"rows={rows} % block_rows={block_rows} != 0")


def dbuf_copy_plain(x: torch.Tensor, *, block_rows: int = 256,
                    num_buffers: int = 2) -> torch.Tensor:
    """The Pallas schedule in plain PyTorch, one ``(block_rows, cols)``
    block per step through ``num_buffers`` slot buffers: the prologue
    fills ``num_buffers - 1`` slots, step i loads block i + nb - 1 ahead,
    and each slot is written out before it is loaded again."""
    _check_blocks(x, block_rows)
    nblocks = x.shape[0] // block_rows
    bufs = torch.empty((num_buffers, block_rows) + tuple(x.shape[1:]),
                       dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)

    def in_copy(i):
        bufs[i % num_buffers].copy_(x[i * block_rows:(i + 1) * block_rows])

    for k in range(min(num_buffers - 1, nblocks)):
        in_copy(k)
    for i in range(nblocks):
        if i + num_buffers - 1 < nblocks:
            in_copy(i + num_buffers - 1)
        out[i * block_rows:(i + 1) * block_rows].copy_(bufs[i % num_buffers])
    return out


def dbuf_copy(x: torch.Tensor, *, block_rows: int = 256,
              num_buffers: int = 2) -> torch.Tensor:
    """Copy (rows, cols) through `num_buffers` stages; ``block_rows`` must
    divide ``rows``. The CUDA kernel's stages are its own 24 KB tiles."""
    global launches
    _check_blocks(x, block_rows)
    if num_buffers < 1:
        raise ValueError(f"num_buffers={num_buffers} must be >= 1")
    if x.device.type == "cpu":
        return dbuf_copy_plain(x, block_rows=block_rows,
                               num_buffers=num_buffers)
    if x.device.type != "cuda":
        raise ValueError(f"dbuf_copy takes CPU or CUDA tensors, not {x.device}")
    lib = _library()
    deepest = lib.repro_dbuf_max_buffers()
    if num_buffers > deepest:
        raise ValueError(f"num_buffers={num_buffers} above the {deepest} "
                         f"stages of {lib.repro_dbuf_tile_bytes()} bytes "
                         "that one CTA's shared memory holds")
    x = x.contiguous()
    # a fresh block, 16-byte aligned: a source that is not takes the
    # kernel's shifted stores, in the same one launch
    out = torch.empty_like(x)
    index = x.device.index
    key = (index, torch._C._cuda_getCurrentRawStream(index))
    counter = _counters.get(key)
    if counter is None:
        counter = _counters[key] = torch.zeros(2, dtype=torch.int64,
                                               device=x.device)
    sms = _sms.get(index)
    if sms is None:
        sms = _sms[index] = torch.cuda.get_device_properties(
            x.device).multi_processor_count
    err = _build.launch(
        lib.repro_dbuf_copy, x.device, x.data_ptr(), out.data_ptr(),
        x.numel() * x.element_size(), num_buffers, sms, counter.data_ptr())
    _build.check(lib, err, "dbuf_copy")
    launches += 1
    return out
