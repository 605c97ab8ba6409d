"""Build the port's CUDA sources into shared libraries, at first use.

Each ``csrc/<name>.cu`` compiles with nvcc, for ``sm_90a``, into
``build/repro_torch/<name>-<hash>.so`` at the repository root. The hash
covers every source under ``csrc/`` and the flags, so an edited source
builds anew and an unchanged one is found built. The library has a plain
C interface and is loaded with ctypes. Nothing here runs at import: the
wrappers call :func:`library` when they first launch a kernel, and
``chip_smoke.py`` calls :func:`build` to start every build at once.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Built:
    name: str
    path: Path
    seconds: float          # build time; 0.0 when it was found built
    log: str                # nvcc and ptxas output of the build that made it


_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or in "
                       "/usr/local/cuda/bin: the port's kernels are built "
                       "on a machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _target(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def build(names: list[str]) -> dict[str, Built]:
    """Build the named sources, one nvcc each, all started together."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[str, Built] = {}
    running: dict[str, tuple[subprocess.Popen, Path, float]] = {}
    try:
        for name in names:
            target = _target(name)
            if target.exists():
                out[name] = Built(name, target, 0.0,
                                  target.with_suffix(".log").read_text())
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            running[name] = (proc, tmp, time.perf_counter())
        for name, (proc, tmp, t0) in running.items():
            log, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                                   f"(exit {proc.returncode}):\n{log}")
            target = _target(name)
            target.with_suffix(".log").write_text(log)
            os.replace(tmp, target)
            out[name] = Built(name, target, seconds, log)
    finally:
        for proc, tmp, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name].path))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (``cudaGetLastError()``)."""
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.repro_cuda_error_string(err).decode())


def launch(fn, device, *args) -> int:
    """Call the C entry ``fn(*args, stream)`` on ``device``'s current
    stream; the device guard is entered only when ``device`` is not the
    current device already. Returns what ``fn`` returns. The stream is
    read as a raw pointer, as PyTorch's own generated kernels read it,
    without building a ``torch.cuda.Stream`` a call."""
    import torch
    raw_stream = torch._C._cuda_getCurrentRawStream
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return fn(*args, raw_stream(device.index))
    return fn(*args, raw_stream(device.index))
