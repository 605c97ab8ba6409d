"""Fine-grained P-chase: the Hopper port of the Pallas TPU kernel
``repro/kernels/pchase.py::_pchase_kernel`` (paper Listing 3).

The kernel is CUDA C++ in ``csrc/pchase.cu`` (its note gives the load
path, the carveout, the bound and the design), built at first launch by
:mod:`._build`. One thread chases ``j = A[j]`` and records the visited
index of every access, bit-exact with :func:`ref.pchase_ref`; it also
stamps every access with SM-clock deltas, which the TPU kernel could not
(:func:`pchase_trace_cycles`). The wrappers dispatch by the array's
device: CPU tensors take :func:`pchase_trace_plain`; CUDA tensors launch
the kernel or raise. Nothing falls back.

:func:`kernel_trace_backend` is the twin of ``pallas_trace_backend``: the
kernel behind the :class:`repro_torch.core.pchase.TraceBackend` contract,
with per-access latency from host-side differential timing.
"""

from __future__ import annotations

import ctypes
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.trace import PChaseConfig, PChaseTrace
from repro_torch.kernels import _build, ref

#: kernel launches made by :func:`pchase_trace` and
#: :func:`pchase_trace_cycles` (the plain version and CPU calls do not
#: count); a caller resets it to 0 and reads it back
launches = 0

_lib: ctypes.CDLL | None = None


class CycleTrace(NamedTuple):
    """What one timed chase on the card gives back."""

    indices: torch.Tensor      # int32[iterations], as pchase_trace
    cycles: torch.Tensor       # int64[iterations], SM cycles per access
    elapsed_cycles: int        # SM cycles of the whole kernel
    elapsed_ns: int            # %globaltimer ns of the whole kernel


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.library("pchase")
        lib.repro_pchase.argtypes = (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 4)
        lib.repro_pchase.restype = ctypes.c_int
        for fn in ("repro_pchase_carveout", "repro_pchase_smem_bytes",
                   "repro_pchase_chunk"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = ctypes.c_int
        _lib = lib
    return _lib


def _padded(array: torch.Tensor, start: int, iterations: int,
            line_elems: int) -> torch.Tensor:
    """The int32 chase array with ``line_elems`` zeros of headroom, as the
    Pallas wrapper pads it; every index it holds, and ``start``, must
    point into it."""
    if array.dim() != 1:
        raise ValueError(f"chase array must be 1-D, not {tuple(array.shape)}")
    if iterations < 0 or line_elems < 1:
        raise ValueError(f"iterations {iterations} and line_elems "
                         f"{line_elems} must be >= 0 and >= 1")
    padded = torch.cat([array.to(torch.int32),
                        torch.zeros(line_elems, dtype=torch.int32,
                                    device=array.device)])
    lo, hi = (int(v) for v in torch.aminmax(padded))
    size = padded.numel()
    if lo < 0 or hi >= size or not 0 <= start < size:
        raise ValueError(f"chase array or start {start} points outside "
                         f"[0, {size}): values in [{lo}, {hi}]")
    return padded


def pchase_trace_plain(array: torch.Tensor, start: int = 0, *,
                       iterations: int, line_elems: int = 8) -> torch.Tensor:
    """The chase in plain Python over a CPU copy (:func:`ref.pchase_ref`)."""
    padded = _padded(array, int(start), iterations, line_elems)
    out = ref.pchase_ref(padded.cpu().numpy(), iterations, int(start))
    return torch.from_numpy(out).to(array.device)


def _launch(padded: torch.Tensor, start: int, iterations: int,
            cycles: torch.Tensor | None,
            clocks: torch.Tensor | None) -> torch.Tensor:
    global launches
    out = torch.empty(iterations, dtype=torch.int32, device=padded.device)
    if iterations == 0:
        return out
    lib = _library()
    err = _build.launch(
        lib.repro_pchase, padded.device, padded.data_ptr(), start,
        iterations, out.data_ptr(),
        None if cycles is None else cycles.data_ptr(),
        None if clocks is None else clocks.data_ptr())
    _build.check(lib, err, "pchase")
    launches += 1
    return out


def _device_of(array: torch.Tensor) -> str:
    if array.device.type not in ("cpu", "cuda"):
        raise ValueError(f"chase array on {array.device}: the kernel takes "
                         "CUDA tensors, the plain version CPU ones")
    return array.device.type


def pchase_trace(array: torch.Tensor, start: int = 0, *, iterations: int,
                 line_elems: int = 8) -> torch.Tensor:
    """Run the chase; returns the int32 index trace (length `iterations`).

    ``line_elems`` zeros pad the array as the Pallas wrapper pads it (the
    TPU kernel fetched 32-byte lines; this kernel loads one element)."""
    if _device_of(array) == "cpu":
        return pchase_trace_plain(array, start, iterations=iterations,
                                  line_elems=line_elems)
    return _launch(_padded(array, int(start), iterations, line_elems),
                   int(start), iterations, None, None)


def pchase_trace_cycles(array: torch.Tensor, start: int = 0, *,
                        iterations: int, line_elems: int = 8) -> CycleTrace:
    """The chase on the card with the SM-clock delta of every access.

    Only the kernel has a clock to read: a CPU tensor raises."""
    if _device_of(array) != "cuda":
        raise ValueError("cycle stamps come only from the kernel: pass a "
                         "CUDA tensor")
    padded = _padded(array, int(start), iterations, line_elems)
    cycles = torch.empty(iterations, dtype=torch.int32, device=array.device)
    clocks = torch.zeros(2, dtype=torch.int64, device=array.device)
    idx = _launch(padded, int(start), iterations, cycles, clocks)
    # the kernel wrote uint32 deltas into the int32 buffer: read them back
    elapsed = clocks.tolist()
    return CycleTrace(idx, cycles.to(torch.int64) & 0xFFFFFFFF,
                      int(elapsed[0]), int(elapsed[1]))


def uniform_init(num_elems: int, stride_elems: int,
                 device: str | torch.device | None = None) -> torch.Tensor:
    """Paper Listing 1: ``A[i] = (i + s) % N``, on ``device`` (cuda by
    default)."""
    i = torch.arange(num_elems, dtype=torch.int32,
                     device=resolve_device(device))
    return (i + stride_elems) % num_elems


# ---------------------------------------------------------------------------
# TraceBackend adapter: the kernel behind the simulator backends' contract
# ---------------------------------------------------------------------------


def chase_array_from_indices(indices, num_elems: int,
                             device: str | torch.device | None = None
                             ) -> torch.Tensor:
    """Chase array A with ``A[x_t] = x_{t+1}`` for an explicit visit stream.

    Only *functional* streams (each index has a single successor) can run
    on hardware, since the kernel dereferences memory instead of replaying
    a list; inconsistent streams raise ValueError. The last index wraps to
    the first so the chase is closed.
    """
    idx = np.asarray(indices, dtype=np.int64)
    succ: dict[int, int] = {}
    for a, b in zip(idx[:-1], idx[1:]):
        prev = succ.setdefault(int(a), int(b))
        if prev != int(b):
            raise ValueError(
                f"index stream is not a chase: {a} has successors "
                f"{prev} and {int(b)}")
    succ.setdefault(int(idx[-1]), int(idx[0]))
    arr = np.arange(num_elems, dtype=np.int32)   # self-loop for unvisited
    for a, b in succ.items():
        arr[a] = b
    return torch.from_numpy(arr).to(resolve_device(device))


def kernel_trace_backend(*, line_elems: int = 8, repeats: int = 2,
                         device: str | torch.device | None = None):
    """A :class:`repro_torch.core.pchase.TraceBackend` driving the kernel.

    The per-access *index* stream comes bit-exact from the kernel; the
    per-access *latency* is the host-side differential-timing slope
    (wall-time difference between a full-length and a half-length chase
    divided by the iteration delta, valid because the chase is serially
    dependent), repeated ``repeats`` times and min-reduced, clamped at 0.
    The slope is a single number, so these traces carry one flat latency
    per access in ns, as the reference backend's do. ``device`` is cuda by
    default; ``"cpu"`` runs the plain version.
    """
    dev = resolve_device(device)

    def _timed_chase(arr: torch.Tensor, start: int, iters: int) -> tuple:
        # as the reference: the wait for the device and the copy of the
        # trace to the host are inside the timed region
        t0 = time.perf_counter()
        out = pchase_trace(arr, start, iterations=iters,
                           line_elems=line_elems)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out.cpu().numpy(), time.perf_counter() - t0

    def run(config: PChaseConfig, indices=None) -> PChaseTrace:
        n = config.num_elems
        if indices is None:
            arr = uniform_init(n, config.stride_elems, dev)
            # chase from the predecessor of 0 so the recorded stream equals
            # uniform_chase_indices: 0, s, 2s, ... (kernel records A[j])
            start = (-config.stride_elems) % n
            k = config.iterations
            rec_full, _ = _timed_chase(arr, start, k)
            rec = rec_full.astype(np.int64)
        else:
            rec = np.asarray(indices, dtype=np.int64)
            arr = chase_array_from_indices(rec, n, dev)
            k = len(rec)
            out, _ = _timed_chase(arr, int(rec[0]), max(1, k - 1))
            got = np.concatenate([[rec[0]], out[:k - 1].astype(np.int64)])
            if not np.array_equal(got, rec):
                raise ValueError("kernel chase diverged from index stream")
        # differential timing: slope between full- and half-length chases,
        # entering the chase where the recorded stream does (index 0 may be
        # a self-loop for explicit streams that never visit it)
        t_start = int(rec[0]) if len(rec) else 0
        half = max(1, k // 2)
        best = float("inf")
        for _ in range(repeats):
            _, t_full = _timed_chase(arr, t_start, k)
            _, t_half = _timed_chase(arr, t_start, half)
            if k > half:
                best = min(best, (t_full - t_half) / (k - half))
        per_access_ns = 0.0 if best == float("inf") else max(0.0, best * 1e9)
        lat = np.full(k, per_access_ns, dtype=np.float64)
        return PChaseTrace(config, rec[:k], lat,
                           meta={"timing": "differential",
                                 "per_access_ns": per_access_ns,
                                 "device": str(dev)})

    return run
