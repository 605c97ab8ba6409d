#!/usr/bin/env python3
"""Time the port's streaming copies against ``Tensor.copy_`` on one card.

    python3 copy_sweep.py [--designs] [--rounds N] [--calls N] [--out FILE]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
Every time is taken at float32 (262144, 1024), 1 GiB, by
``chip_smoke.copy_times_in_turns``, as ``chip_smoke.py`` times the copies:
a copy and ``copy_`` from the same array into a preallocated block in
turns (copy, copy_, copy_, copy, ``--rounds`` times), each turn the CUDA
event mean of ``--calls`` calls, each call's device ms from one
torch.profiler trace of the turns. Each line printed is one JSON object:
the medians, their ratios to ``copy_``'s and GB/s (2 x bytes over time).

By default it times the wrappers as a caller calls them: ``memcpy``, and
``dbuf_copy`` at the depths of ``chip_smoke.py``'s curve. It imports the
``repro_torch`` that comes first on ``sys.path`` (this checkout's ``src``
last), so that ``PYTHONPATH=<another checkout>/src`` times that
checkout's copies by the same method. With ``--designs`` it times this
checkout's designs of ``csrc/copy_variants.cu`` that the lists below name,
each checked exact first, and then the launched copies into
``PLACEMENTS`` blocks of their own; it exits 1 if a design is not exact.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPE = (262144, 1024)
NBYTES = SHAPE[0] * SHAPE[1] * 4
DEPTHS = (1, 2, 3, 4, 6, 8)
#: memcpy: persistent grids of (CTAs an SM, threads a CTA) whose spans are
#: fixed shares (span 0 the grid, 1 a CTA, 2 a warp), at these ILPs; grids
#: of one batch a CTA, as large as the array needs; the (load, store) cache
#: hints of csrc/copy_variants.cu, tried on the launched design
MEMCPY_PERSISTENT = ((1, 512), (2, 256), (4, 256), (8, 256))
MEMCPY_PERSISTENT_ILP = (2, 4, 8, 16)
MEMCPY_ONE_BATCH = ((128, 256, 512), (1, 2, 4, 8, 16))
MEMCPY_HINTS = ((1, 0), (2, 0), (3, 0), (0, 1), (0, 2), (0, 3))
#: dbuf_copy: depths; a CTA's tiles (0 every grid-th, 1 a contiguous run,
#: 2 claimed from a counter); the launched tile; other tiles at depth 2
DBUF_DEPTHS = (1, 2, 3, 4, 6, 8, 9)
DBUF_TILE = 24576
DBUF_TILES = (4096, 8192, 12288, 16384, 20480, 32768)
#: blocks of their own that the launched copies also write
PLACEMENTS = 4
ALL_CTAS = 2 ** 31 - 1


def launched_lag(nb: int) -> int:
    """dbuf_copy.cu's ``lag_for``."""
    return nb // 2 if nb in (3, 4) else 0


def memcpy_designs():
    for (cps, threads), ilp, span in itertools.product(
            MEMCPY_PERSISTENT, MEMCPY_PERSISTENT_ILP, (0, 1, 2)):
        yield dict(ctas_per_sm=cps, threads=threads, ilp=ilp, span=span,
                   load_hint=0, store_hint=0)
    for threads, ilp in itertools.product(*MEMCPY_ONE_BATCH):
        yield dict(ctas_per_sm=0, threads=threads, ilp=ilp, span=1,
                   load_hint=0, store_hint=0)
    for lh, sh in MEMCPY_HINTS:
        yield dict(ctas_per_sm=0, threads=256, ilp=2, span=1, load_hint=lh,
                   store_hint=sh)


def dbuf_designs():
    for nb in DBUF_DEPTHS:
        for lag in sorted({0, 1, nb // 2, nb - 1} & set(range(nb))):
            yield dict(num_buffers=nb, tile_bytes=DBUF_TILE, lag=lag,
                       tiles=2, hint=0)
    for tiles, nb, tile in itertools.product((0, 1), (2, 4, 8),
                                             (16384, DBUF_TILE)):
        if 128 + nb * tile <= 232448:
            for lag in sorted({0, nb // 2}):
                yield dict(num_buffers=nb, tile_bytes=tile, lag=lag,
                           tiles=tiles, hint=0)
    for tile in DBUF_TILES:
        yield dict(num_buffers=2, tile_bytes=tile, lag=0, tiles=2, hint=0)
    for nb in DBUF_DEPTHS:
        yield dict(num_buffers=nb, tile_bytes=DBUF_TILE,
                   lag=launched_lag(nb), tiles=2, hint=1)


def summary(t: dict) -> dict:
    """The turns' medians, their ratios to copy_'s and GB/s."""
    return dict(
        device_ratio=t["device_ms"] / t["library_device_ms"],
        event_ratio=t["ms"] / t["library_ms"],
        device_gbps=2 * NBYTES / t["device_ms"] / 1e6,
        copy_device_gbps=2 * NBYTES / t["library_device_ms"] / 1e6,
        gbps=2 * NBYTES / t["ms"] / 1e6,
        copy_gbps=2 * NBYTES / t["library_ms"] / 1e6,
        device_ms=t["device_ms"], copy_device_ms=t["library_device_ms"],
        ms=t["ms"], copy_ms=t["library_ms"], spread=t["spread"],
        trace_complete=t["device_trace"]["complete"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--designs", action="store_true",
                    help="the designs of csrc/copy_variants.cu, not the "
                         "wrappers")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the lines to this file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("copy_sweep needs a CUDA card; torch sees none")
    sys.path.append(str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import dbuf_copy as dbuf
    from repro_torch.kernels import memcpy as mc

    card = cs.card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(SHAPE, generator=gen, device="cuda")
    out = torch.empty_like(x)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lines, inexact = [], []

    def emit(**rec):
        rec = {"card": card, "source": str(Path(mc.__file__).parent), **rec}
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    def timed(fn, name, library=lambda: out.copy_(x)):
        return summary(cs.copy_times_in_turns(
            torch, fn, library, name, rounds=args.rounds, calls=args.calls))

    if not args.designs:
        emit(copy="memcpy", **timed(lambda: mc.memcpy(x), "memcpy_kernel"))
        for nb in DEPTHS:
            emit(copy="dbuf_copy", num_buffers=nb, **timed(
                lambda: dbuf.dbuf_copy(x, num_buffers=nb), "dbuf_kernel"))
    else:
        lib = _build.library("copy_variants")
        for fn in ("repro_memcpy_variant", "repro_dbuf_copy_variant"):
            getattr(lib, fn).restype = ctypes.c_int
        lib.repro_memcpy_variant.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            *[ctypes.c_int] * 6, ctypes.c_void_p]
        lib.repro_dbuf_copy_variant.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            *[ctypes.c_int] * 6, ctypes.c_void_p, ctypes.c_void_p]
        counter = torch.zeros(2, dtype=torch.int64, device="cuda")

        def run(copy, name, kernel, design):
            out.zero_()
            kernel()
            exact = torch.equal(out, x)
            if not exact:
                inexact.append((copy, design))
            emit(copy=copy, design=design, exact=exact, **timed(kernel, name))

        emit(copy="elementwise", design="torch.mul(x, 1.0, out=out)",
             **timed(lambda: torch.mul(x, 1.0, out=out), "elementwise"))
        for d in memcpy_designs():
            run("memcpy", "memcpy_variant", lambda d=d: _build.check(
                lib, _build.launch(
                    lib.repro_memcpy_variant, x.device, x.data_ptr(),
                    out.data_ptr(), NBYTES, d["ctas_per_sm"] * sms or ALL_CTAS,
                    d["threads"], d["ilp"], d["span"], d["load_hint"],
                    d["store_hint"]), "memcpy variant"), d)
        for d in dbuf_designs():
            run("dbuf_copy", "dbuf_variant", lambda d=d: _build.check(
                lib, _build.launch(
                    lib.repro_dbuf_copy_variant, x.device, x.data_ptr(),
                    out.data_ptr(), NBYTES, d["num_buffers"], sms,
                    d["tile_bytes"], d["lag"], d["tiles"], d["hint"],
                    counter.data_ptr()), "dbuf_copy variant"), d)
        # where the copy lands: the launched copies and copy_ into blocks of
        # their own, each in turns with copy_ into the same block
        mlib, dlib = mc._library(), dbuf._library()
        dcounter = torch.zeros(2, dtype=torch.int64, device="cuda")
        blocks = []     # held, so that each placement gets a block of its own
        for k in range(PLACEMENTS):
            dst = torch.empty_like(x)
            blocks.append(dst)
            for copy, name, clib, entry, extra in (
                    ("memcpy", "memcpy_kernel", mlib, mlib.repro_memcpy, ()),
                    ("dbuf_copy", "dbuf_kernel", dlib, dlib.repro_dbuf_copy,
                     (2, sms, dcounter.data_ptr()))):
                def kernel(clib=clib, entry=entry, extra=extra, dst=dst,
                           copy=copy):
                    _build.check(clib, _build.launch(
                        entry, x.device, x.data_ptr(), dst.data_ptr(),
                        NBYTES, *extra), copy)
                emit(copy=copy, placement=k,
                     dst_minus_src_mib=(dst.data_ptr() - x.data_ptr()) / 2**20,
                     **timed(kernel, name, lambda dst=dst: dst.copy_(x)))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in lines))
    if inexact:
        print(f"not exact: {inexact}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
