"""The batched cache engine's scan as a CUDA kernel: the Hopper port of
the jitted ``lax.scan`` of ``repro/core/cachesim_jax.py::_scan_kernel``
(``_lane_scan``), which XLA compiles (it has no ``pallas_call``).

The kernel is CUDA C++ in ``csrc/batch_cache.cu`` (its note gives the
bound and the design): one CTA a lane, the lane's tag and stamp planes in
shared memory, the threads over the ways. :func:`batch_cache_scan`
dispatches by the tensors' device: CPU tensors take the plain version
(:func:`repro_torch.kernels.ref.batch_cache_ref`); CUDA tensors launch the
kernel or raise, as for a lane whose planes do not fit one CTA's shared
memory. Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

#: kernel launches made by :func:`batch_cache_scan` (the plain version and
#: CPU calls do not count); a caller resets it to 0 and reads it back
launches = 0

_lib: ctypes.CDLL | None = None
#: the opt-in shared memory of a CTA, by device index, read once
_max_smem: dict[int, int] = {}

_DTYPES = {"ways": torch.int32, "policy": torch.int32, "cum": torch.float32,
           "sets": torch.int32, "lines": torch.int32, "valid": torch.bool,
           "u": torch.float32}


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.library("batch_cache")
        lib.repro_batch_cache.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
               ctypes.c_void_p])
        lib.repro_batch_cache.restype = ctypes.c_int
        lib.repro_batch_cache_smem_bytes.argtypes = [ctypes.c_int,
                                                     ctypes.c_int]
        lib.repro_batch_cache_smem_bytes.restype = ctypes.c_longlong
        lib.repro_batch_cache_max_smem.argtypes = []
        lib.repro_batch_cache_max_smem.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(ways, policy, cum, sets, lines, valid, u) -> None:
    """Shapes and types, on every device."""
    args = dict(ways=ways, policy=policy, cum=cum, sets=sets, lines=lines,
                valid=valid, u=u)
    for name, t in args.items():
        if t.dtype != _DTYPES[name]:
            raise ValueError(f"{name} must be {_DTYPES[name]}, not {t.dtype}")
        if t.device != ways.device:
            raise ValueError(f"{name} is on {t.device}, ways on {ways.device}")
    if ways.dim() != 2 or cum.dim() != 2 or policy.shape != ways.shape[:1]:
        raise ValueError(f"ways (B, T), policy (B,) and cum (B, W) expected, "
                         f"not {tuple(ways.shape)}, {tuple(policy.shape)} "
                         f"and {tuple(cum.shape)}")
    b = ways.shape[0]
    if cum.shape[0] != b or any(t.shape != sets.shape or t.dim() != 2
                                or t.shape[0] != b
                                for t in (sets, lines, valid, u)):
        raise ValueError("sets, lines, valid and u must be (B, K) and cum "
                         "(B, W) for the B lanes of ways")


def lane_dims(ways: torch.Tensor) -> list[tuple[int, int]]:
    """Each lane's own (T, W): its sets (the last with ways, plus one) and
    its widest set, as the kernel reads them from ``ways``."""
    out = []
    for row in ways.cpu().tolist():
        t = max((i + 1 for i, n in enumerate(row) if n > 0), default=0)
        out.append((t, max(row[:t], default=0)))
    return out


def batch_cache_scan(ways: torch.Tensor, policy: torch.Tensor,
                     cum: torch.Tensor, sets: torch.Tensor,
                     lines: torch.Tensor, valid: torch.Tensor,
                     u: torch.Tensor) -> torch.Tensor:
    """Hit bits ``(B, K)`` of every lane's access stream, each lane from
    cold (the arguments are :func:`ref.batch_cache_ref`'s)."""
    global launches
    _check(ways, policy, cum, sets, lines, valid, u)
    if ways.device.type == "cpu":
        return ref.batch_cache_ref(ways, policy, cum, sets, lines, valid, u)
    if ways.device.type != "cuda":
        raise ValueError(f"batch_cache_scan takes CPU or CUDA tensors, not "
                         f"{ways.device}")
    lib = _library()
    index = ways.device.index
    if index not in _max_smem:
        with torch.cuda.device(ways.device):
            _max_smem[index] = lib.repro_batch_cache_max_smem()
    need = max((lib.repro_batch_cache_smem_bytes(t, w)
                for t, w in lane_dims(ways)), default=0)
    if need > _max_smem[index]:
        raise ValueError(f"a lane's tag and stamp planes need {need} bytes "
                         f"of shared memory; one CTA holds "
                         f"{_max_smem[index]}")
    b, k = sets.shape
    hits = torch.empty((b, k), dtype=torch.bool, device=ways.device)
    if b == 0 or k == 0:
        return hits
    args = [t.contiguous() for t in (ways, policy, cum, sets, lines, valid,
                                     u)]
    threads = min(256, max(32, -(-cum.shape[1] // 32) * 32))
    err = _build.launch(
        lib.repro_batch_cache, ways.device, *(t.data_ptr() for t in args),
        hits.data_ptr(), b, ways.shape[1], cum.shape[1], k, threads, need)
    _build.check(lib, err, "batch_cache")
    launches += 1
    return hits
