"""The port's hardware-measurement path against the JAX package.

P-chase, the trace backend, the paper's measurement methods and classic
interpreters, the streaming copies and the strided gather. On the CPU the
port's wrappers run their plain versions; the JAX side runs its Pallas
kernels in interpret mode, as its own tests do. Inputs are made with
numpy from a seed and handed to both. Index traces, copies and gathers
are compared exactly; wall-clock latencies are not compared. The tests
marked ``gpu`` hold each CUDA kernel to its plain version on the card and
skip without one.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import classic as jclassic
from repro.core import pchase as jpchase
from repro.core import trace as jtrace
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.dbuf_copy import dbuf_copy as jdbuf_copy
from repro.kernels.pchase import chase_array_from_indices as jchase_array
from repro.kernels.pchase import pallas_trace_backend
from repro_torch.core import classic, pchase as cpchase, trace
from repro_torch.kernels import dbuf_copy as dbuf
from repro_torch.kernels import memcpy as mc
from repro_torch.kernels import ops, ref
from repro_torch.kernels import pchase as pc
from repro_torch.kernels import strided as st

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


def _uniform(n, stride):
    return ((np.arange(n) + stride) % n).astype(np.int32)


def _single_cycle(n, seed):
    perm = np.random.default_rng(seed).permutation(n)
    a = np.empty(n, dtype=np.int32)
    a[perm] = np.roll(perm, -1)
    return a


def _array(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        a = rng.integers(-128, 128, size=shape).astype(np.int8)
    else:
        a = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _as_np(x):
    """Exact numpy view of either side's result (bf16 widens to f32)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


# -- P-chase -------------------------------------------------------------------


@pytest.mark.parametrize("n,stride", [(64, 4), (128, 8), (96, 12), (1024, 32)])
def test_uniform_chase_matches_jax(n, stride):
    a = _uniform(n, stride)
    k = 2 * n // stride
    want = np.asarray(jops.pchase_trace(a, k, interpret=True))
    got = ops.pchase_trace(torch.from_numpy(a), k)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pc.uniform_init(n, stride, "cpu").numpy(), a)


def test_permutation_chase_matches_jax():
    a = np.random.default_rng(0).permutation(256).astype(np.int32)
    want = np.asarray(jops.pchase_trace(a, 300, interpret=True))
    np.testing.assert_array_equal(ops.pchase_trace(torch.from_numpy(a),
                                                   300).numpy(), want)
    np.testing.assert_array_equal(ref.pchase_ref(a, 300),
                                  jref.pchase_ref(a, 300))


def test_start_offset_matches_jax():
    a = _uniform(64, 4)
    want = np.asarray(jops.pchase_trace(a, 10, start=8, interpret=True))
    np.testing.assert_array_equal(
        ops.pchase_trace(torch.from_numpy(a), 10, start=8).numpy(), want)


def test_chase_rejects_indices_outside_the_array():
    a = torch.from_numpy(_uniform(64, 4))
    bad = a.clone()
    bad[3] = 64 + 8                    # past the 8 elements of padding
    with pytest.raises(ValueError, match="outside"):
        pc.pchase_trace(bad, iterations=4)
    with pytest.raises(ValueError, match="outside"):
        pc.pchase_trace(a, -1, iterations=4)
    with pytest.raises(ValueError, match="cycle stamps"):
        pc.pchase_trace_cycles(a, iterations=4)


# -- the trace backend -----------------------------------------------------------

UNIFORM_CONFIGS = [(256, 16, 40),      # n % s == 0
                   (240, 32, 30),      # 60 elements, stride 8: n % s != 0
                   (1024, 128, 24)]


@pytest.mark.parametrize("array_bytes,stride_bytes,iterations",
                         UNIFORM_CONFIGS)
def test_backend_uniform_matches_jax(array_bytes, stride_bytes, iterations):
    want = pallas_trace_backend(interpret=True, repeats=1)(
        jtrace.PChaseConfig(array_bytes, stride_bytes, iterations))
    got = pc.kernel_trace_backend(device="cpu", repeats=1)(
        trace.PChaseConfig(array_bytes, stride_bytes, iterations))
    assert dataclasses.astuple(got.config) == dataclasses.astuple(want.config)
    np.testing.assert_array_equal(got.indices, want.indices)
    assert got.indices.dtype == np.int64 and got.latencies.dtype == np.float64
    assert got.latencies.shape == want.latencies.shape
    assert np.all(got.latencies == got.meta["per_access_ns"])
    assert got.meta["per_access_ns"] >= 0.0
    if got.config.num_elems % got.config.stride_elems == 0:
        # the simulators' stream, np.resize of one pass, is the chase only
        # when the stride tiles the array; otherwise the chase wraps to s - r
        np.testing.assert_array_equal(
            got.indices,
            np.resize(cpchase.uniform_chase_indices(got.config), iterations))
    assert set(got.meta) - {"device"} == set(want.meta) - {"interpret"}
    assert got.meta["device"] == "cpu" and got.meta["timing"] == "differential"


def test_backend_explicit_stream_matches_jax():
    stream = np.array([0, 5, 3, 9, 12, 0, 5, 3, 9, 12, 0])
    cfg = (64, 4, len(stream))
    want = pallas_trace_backend(interpret=True, repeats=1)(
        jtrace.PChaseConfig(*cfg), stream)
    got = pc.kernel_trace_backend(device="cpu", repeats=1)(
        trace.PChaseConfig(*cfg), stream)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.indices, stream)
    np.testing.assert_array_equal(
        pc.chase_array_from_indices(stream, 16, "cpu").numpy(),
        np.asarray(jchase_array(stream, 16)))


def test_backend_rejects_a_stream_that_is_not_a_chase():
    stream = np.array([0, 1, 0, 2])
    cfg = (64, 4, len(stream))
    with pytest.raises(ValueError) as want:
        pallas_trace_backend(interpret=True, repeats=1)(
            jtrace.PChaseConfig(*cfg), stream)
    with pytest.raises(ValueError) as got:
        pc.kernel_trace_backend(device="cpu", repeats=1)(
            trace.PChaseConfig(*cfg), stream)
    assert str(got.value) == str(want.value)


# -- the measurement methods and classic interpreters ------------------------------


def _fake_backend(trace_mod, pchase_mod):
    """Latency as a fixed function of the index: 200 in the upper half of
    every 8 KB, 20 in the lower, plus the index mod 3."""

    def run(config, indices=None):
        rec = (np.resize(pchase_mod.uniform_chase_indices(config),
                         config.iterations) if indices is None
               else np.asarray(indices))
        addr = rec * config.elem_bytes
        lat = np.where(addr % 8192 >= 4096, 200.0, 20.0) + rec % 3
        return trace_mod.PChaseTrace(config, rec, lat, meta={"fake": True})

    return run


SIZES = [1024 * k for k in (1, 2, 4, 6, 8, 12, 16)]
STRIDES = [4 * 2 ** k for k in range(12)]


def test_measurement_methods_match_jax():
    jb = _fake_backend(jtrace, jpchase)
    tb = _fake_backend(trace, cpchase)
    for args in ((8192, 256), (6000, 64, 50), (4096, 4)):
        want = jpchase.fine_grained(jb, *args)
        got = cpchase.fine_grained(tb, *args)
        assert dataclasses.astuple(got.config) == \
            dataclasses.astuple(want.config)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.latencies, want.latencies)
    assert cpchase.wong2010(tb, SIZES, 128) == jpchase.wong2010(jb, SIZES, 128)
    assert cpchase.saavedra1992(tb, 16384, STRIDES) == \
        jpchase.saavedra1992(jb, 16384, STRIDES)


def test_classic_interpreters_match_jax():
    jb = _fake_backend(jtrace, jpchase)
    wong = jpchase.wong2010(jb, SIZES, 128)
    saav = jpchase.saavedra1992(jb, 16384, STRIDES)
    curves = [({256: 20.0, 512: 20.5, 768: 60.0, 1024: 61.0, 1280: 100.0},
               {4: 10.0, 8: 14.0, 16: 30.0, 32: 30.0, 64: 30.0, 128: 10.0})]
    curves.append((wong, saav))
    for w, s in curves:
        got = classic.interpret_wong(w, 4096)
        assert dataclasses.asdict(got) == dataclasses.asdict(
            jclassic.interpret_wong(w, 4096))
        got = classic.interpret_saavedra(s, 16384, 4096)
        assert dataclasses.asdict(got) == dataclasses.asdict(
            jclassic.interpret_saavedra(s, 16384, 4096))


def test_index_constructors_match_jax():
    for args in ((1024, 64, 10), (240, 32, 7), (4096, 4, 100)):
        for passes in (1.0, 2.5, 0):
            np.testing.assert_array_equal(
                cpchase.uniform_chase_indices(trace.PChaseConfig(*args),
                                              passes),
                jpchase.uniform_chase_indices(jtrace.PChaseConfig(*args),
                                              passes))
    a = _single_cycle(200, seed=4)
    np.testing.assert_array_equal(cpchase.chase_from_array(a, 250, 7),
                                  jpchase.chase_from_array(a, 250, 7))


def test_trace_properties_match_jax():
    rng = np.random.default_rng(1)
    idx = np.resize(np.arange(0, 64, 4), 48)
    lat = np.where(rng.random(48) < 0.3, 300.0, 30.0) + rng.random(48)
    for period_lat in (lat, np.tile(lat[:16], 3), np.full(48, 7.0)):
        args = ((256, 16, 48), idx, period_lat)
        want = jtrace.PChaseTrace(jtrace.PChaseConfig(*args[0]), *args[1:])
        got = trace.PChaseTrace(trace.PChaseConfig(*args[0]), *args[1:])
        assert got.tavg == want.tavg
        for th in (None, 100.0):
            np.testing.assert_array_equal(got.miss_mask(th),
                                          want.miss_mask(th))
            assert got.miss_count(th) == want.miss_count(th)
            assert got.miss_rate(th) == want.miss_rate(th)
            np.testing.assert_array_equal(got.missed_addresses(th),
                                          want.missed_addresses(th))
        assert got.is_periodic() == want.is_periodic()
        assert got.is_periodic(16) == want.is_periodic(16)
    with pytest.raises(ValueError, match="mismatch"):
        trace.PChaseTrace(trace.PChaseConfig(64, 4, 2), [0, 1], [1.0])


# -- streaming copies ------------------------------------------------------------

COPY_SHAPES = [((512, 128), 128), ((1024, 256), 256), ((256, 512), 64)]


@pytest.mark.parametrize("shape,block", COPY_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_memcpy_matches_jax(shape, block, dtype):
    jx, tx = _array(shape, dtype)
    want = jops.memcpy(jx, block_rows=block, interpret=True)
    got = ops.memcpy(tx, block_rows=block)
    assert got.dtype == tx.dtype and got.data_ptr() != tx.data_ptr()
    np.testing.assert_array_equal(_as_np(got), _as_np(want))
    np.testing.assert_array_equal(_as_np(got), _as_np(ref.memcpy_ref(tx)))


def test_memcpy_bad_block_raises_like_jax():
    with pytest.raises(ValueError) as want:
        jops.memcpy(jnp.ones((100, 128)), block_rows=64, interpret=True)
    with pytest.raises(ValueError) as got:
        ops.memcpy(torch.ones((100, 128)), block_rows=64)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("num_buffers", [1, 2, 3, 4])
@pytest.mark.parametrize("rows,block", [(256, 64), (512, 128), (64, 64)])
def test_dbuf_copy_matches_jax(num_buffers, rows, block):
    rng = np.random.default_rng(rows + num_buffers)
    x = rng.standard_normal((rows, 32)).astype(np.float32)
    want = jdbuf_copy(jnp.asarray(x), block_rows=block,
                      num_buffers=num_buffers)
    got = dbuf.dbuf_copy(torch.from_numpy(x), block_rows=block,
                         num_buffers=num_buffers)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), x)


def test_dbuf_copy_more_buffers_than_blocks():
    x = np.random.default_rng(2).standard_normal((64, 8)).astype(np.float32)
    for nb in (2, 4, 7):
        want = jdbuf_copy(jnp.asarray(x), block_rows=32, num_buffers=nb)
        got = dbuf.dbuf_copy(torch.from_numpy(x), block_rows=32,
                             num_buffers=nb)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dbuf_copy_bad_block_raises_like_jax():
    with pytest.raises(ValueError) as want:
        jdbuf_copy(jnp.ones((100, 8)), block_rows=64)
    with pytest.raises(ValueError) as got:
        dbuf.dbuf_copy(torch.ones((100, 8)), block_rows=64)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="num_buffers"):
        dbuf.dbuf_copy(torch.ones((64, 8)), block_rows=64, num_buffers=0)


def test_memcpy_unaligned_view_matches_jax():
    """An int8 view that starts one byte into its storage, of a size that
    is no multiple of 16: the card takes its byte path here."""
    a = np.random.default_rng(7).integers(-128, 128, 333 * 77 + 1
                                          ).astype(np.int8)
    x = torch.from_numpy(a)[1:].view(333, 77)
    want = jops.memcpy(jnp.asarray(a[1:].reshape(333, 77)), block_rows=111,
                       interpret=True)
    np.testing.assert_array_equal(ops.memcpy(x, block_rows=111).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("num_buffers", range(1, 10))
def test_dbuf_copy_ragged_int8_matches_jax(num_buffers):
    """Rows of 4099 bytes: on the card a partial last tile and a 3-byte
    tail."""
    a = np.random.default_rng(num_buffers).integers(-128, 128, (6, 4099)
                                                    ).astype(np.int8)
    want = jdbuf_copy(jnp.asarray(a), block_rows=2, num_buffers=num_buffers)
    got = dbuf.dbuf_copy(torch.from_numpy(a), block_rows=2,
                         num_buffers=num_buffers)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_copy_sweep_lists_only_designs_the_kernels_take():
    """copy_variants.cu's entries refuse (cudaErrorInvalidValue) a design
    outside these limits: threads a multiple of 32 up to 512, ILP 1-16 in
    powers of two, one side's cache hint at a time; a tile a multiple of
    128, at most 16 stages within a CTA's shared memory, a lag below the
    depth and at most 8. Each design is listed once, the launched ones
    among them. Without a card the sweep exits, as every entry point
    does."""
    spec = importlib.util.spec_from_file_location(
        "copy_sweep", Path(__file__).resolve().parents[1] / "copy_sweep.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for designs in (list(cs.memcpy_designs()), list(cs.dbuf_designs())):
        assert len(designs) == len({tuple(d.values()) for d in designs})
    memcpy_designs = list(cs.memcpy_designs())
    for d in memcpy_designs:
        assert d["threads"] % 32 == 0 and 32 <= d["threads"] <= 512
        assert d["ilp"] in (1, 2, 4, 8, 16) and d["span"] in (0, 1, 2)
        assert d["load_hint"] in range(4) and d["store_hint"] in range(4)
        assert d["load_hint"] == 0 or d["store_hint"] == 0
    assert dict(ctas_per_sm=0, threads=256, ilp=2, span=1, load_hint=0,
                store_hint=0) in memcpy_designs
    dbuf_designs = list(cs.dbuf_designs())
    for d in dbuf_designs:
        assert d["tile_bytes"] % 128 == 0 and 1 <= d["num_buffers"] <= 16
        assert 128 + d["num_buffers"] * d["tile_bytes"] <= 232448
        assert 0 <= d["lag"] < d["num_buffers"] and d["lag"] <= 8
        assert d["tiles"] in (0, 1, 2) and d["hint"] in (0, 1)
    for nb in cs.DBUF_DEPTHS:
        assert dict(num_buffers=nb, tile_bytes=cs.DBUF_TILE,
                    lag=cs.launched_lag(nb), tiles=2, hint=0) in dbuf_designs
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            cs.main(["--designs"])


# -- strided gather --------------------------------------------------------------


@pytest.mark.parametrize("n", [32, 64, 128])
@pytest.mark.parametrize("stride", [1, 2, 3, 4, 8, 31, 32, 33, 64, 128, 257])
def test_strided_gather_matches_jax(stride, n):
    x = np.random.default_rng(n).standard_normal((n, 4)).astype(np.float32)
    want = jops.strided_gather(jnp.asarray(x), stride, interpret=True)
    got = ops.strided_gather(torch.from_numpy(x), stride)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ref.strided_ref(torch.from_numpy(x), stride).numpy(),
        np.asarray(jref.strided_ref(jnp.asarray(x), stride)))


@pytest.mark.parametrize("n", [32, 64, 128])
def test_strided_gather_every_stride_matches_ref(n):
    x = torch.arange(n * 256, dtype=torch.float32).reshape(n, 256)
    for stride in range(1, 258):
        torch.testing.assert_close(ops.strided_gather(x, stride),
                                   ref.strided_ref(x, stride), rtol=0, atol=0)


def test_strided_gather_rejects_no_rows():
    with pytest.raises(ValueError, match="rows"):
        st.strided_gather(torch.ones((0, 4)), stride=1)


# -- no launches on the CPU, and the card by default -------------------------------


def test_cpu_paths_launch_nothing():
    mods = (pc, mc, dbuf, st)
    before = [m.launches for m in mods]
    a = torch.from_numpy(_uniform(64, 4))
    ops.pchase_trace(a, 16)
    pc.kernel_trace_backend(device="cpu", repeats=1)(
        trace.PChaseConfig(256, 16, 8))
    assert np.isfinite(ops.pchase_latency_slope(a, 4, 16, repeats=1))
    ops.memcpy(torch.ones((64, 8)), block_rows=32)
    assert ops.memcpy_throughput_gbps((64, 8), block_rows=32, repeats=1,
                                      device="cpu") > 0
    dbuf.dbuf_copy(torch.ones((64, 8)), block_rows=32, num_buffers=3)
    ops.strided_gather(torch.ones((32, 4)), 3)
    assert [m.launches for m in mods] == before


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        pc.kernel_trace_backend()
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.memcpy_throughput_gbps((64, 8), block_rows=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.pchase_trace(_uniform(64, 4), 8)


# -- on the card ---------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch sees no CUDA device)")


@pytest.mark.gpu
def test_pchase_kernel_matches_plain_on_card():
    _card()
    for a, k, start in ((_uniform(1024, 32), 64, 0), (_uniform(64, 4), 10, 8),
                        (_single_cycle(4096, 3), 5000, 11)):
        x = torch.from_numpy(a).cuda()
        before = pc.launches
        got = pc.pchase_trace(x, start, iterations=k)
        cyc = pc.pchase_trace_cycles(x, start, iterations=k)
        torch.cuda.synchronize()
        assert pc.launches == before + 2
        want = pc.pchase_trace_plain(x, start, iterations=k)
        assert torch.equal(got, want) and torch.equal(cyc.indices, want)
        assert bool((cyc.cycles > 0).all()) and cyc.elapsed_ns > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_copies_match_plain_on_card(dtype):
    _card()
    for shape, block in COPY_SHAPES + [((6, 7), 3)]:
        x = _array(shape, dtype)[1].cuda()
        assert torch.equal(mc.memcpy(x, block_rows=block), mc.memcpy_plain(x))
        for nb in (1, 2, 3, 4, 9):
            assert torch.equal(
                dbuf.dbuf_copy(x, block_rows=block, num_buffers=nb),
                dbuf.dbuf_copy_plain(x, block_rows=block, num_buffers=nb))
    with pytest.raises(ValueError, match="not divisible"):
        mc.memcpy(torch.ones((100, 128), device="cuda"), block_rows=64)
    with pytest.raises(ValueError, match="!= 0"):
        dbuf.dbuf_copy(torch.ones((100, 128), device="cuda"), block_rows=64)


def _int8_on_card(n, seed, offset=0):
    """n random int8 bytes on the card, starting ``offset`` bytes into a
    fresh (512-byte aligned) allocation."""
    a = np.random.default_rng(seed).integers(-128, 128, n + offset)
    return torch.from_numpy(a.astype(np.int8)).cuda()[offset:]


@pytest.mark.gpu
def test_memcpy_unaligned_and_ragged_on_card():
    """The byte path (a start one byte past 16-byte alignment, a size that
    is no multiple of 16) and, aligned, a last batch cut short with a 7-byte
    tail: each one launch, exact."""
    _card()
    unaligned = _int8_on_card(333 * 77, 7, offset=1).view(333, 77)
    ragged = _int8_on_card(1021 * 1027, 8).view(1021, 1027)
    assert unaligned.data_ptr() % 16 and unaligned.numel() % 16
    assert ragged.data_ptr() % 16 == 0 and ragged.numel() % 16 == 7
    for x, block in ((unaligned, 111), (ragged, 1021)):
        before = mc.launches
        got = mc.memcpy(x, block_rows=block)
        assert mc.launches == before + 1
        assert torch.equal(got, mc.memcpy_plain(x))


@pytest.mark.gpu
@pytest.mark.parametrize("num_buffers", range(1, 10))
def test_dbuf_copy_partial_tile_and_tail_on_card(num_buffers):
    """Sizes that end in a partial tile of 80 bytes and a 13-byte tail, over
    fewer tiles than CTAs and over more."""
    _card()
    tile = dbuf._library().repro_dbuf_tile_bytes()
    for tiles in (3, 301):
        n = tiles * tile + 5 * 16 + 13
        x = _int8_on_card(n, tiles).view(1, n)
        before = dbuf.launches
        got = dbuf.dbuf_copy(x, block_rows=1, num_buffers=num_buffers)
        assert dbuf.launches == before + 1
        assert torch.equal(got, dbuf.dbuf_copy_plain(
            x, block_rows=1, num_buffers=num_buffers))


@pytest.mark.gpu
@pytest.mark.parametrize("num_buffers", range(1, 10))
def test_dbuf_copy_unaligned_start_on_card(num_buffers):
    """A start 1, 3 and 15 bytes past 16-byte alignment, over 3 tiles and
    a ragged 80 + 13 bytes and over fewer bytes than one tile: each one
    launch, exact (the kernel's shifted stores)."""
    _card()
    tile = dbuf._library().repro_dbuf_tile_bytes()
    for offset in (1, 3, 15):
        for n in (3 * tile + 5 * 16 + 13, 1000):
            x = _int8_on_card(n, offset, offset=offset).view(1, n)
            assert x.data_ptr() % 16 == offset
            before = dbuf.launches
            got = dbuf.dbuf_copy(x, block_rows=1, num_buffers=num_buffers)
            assert dbuf.launches == before + 1
            assert torch.equal(got, dbuf.dbuf_copy_plain(
                x, block_rows=1, num_buffers=num_buffers))


@pytest.mark.gpu
def test_strided_matches_plain_on_card():
    _card()
    for n in (32, 64, 128):
        x = torch.randn((n, 256), device="cuda")
        for stride in range(1, 258):
            assert torch.equal(st.strided_gather(x, stride=stride),
                               st.strided_gather_plain(x, stride=stride))
    x = torch.randint(0, 100, (33, 3), dtype=torch.int8, device="cuda")
    assert torch.equal(st.strided_gather(x, stride=5),
                       st.strided_gather_plain(x, stride=5))
    with pytest.raises(ValueError, match="shared memory"):
        st.strided_gather(torch.ones((1024, 1024), device="cuda"), stride=3)
