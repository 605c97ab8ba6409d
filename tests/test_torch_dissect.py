"""The port's dissection half against the JAX package's, on the same inputs.

The simulator backends' traces (``vector``, ``reference`` and the batched
``torch`` engine on the CPU) must be bit-exact to the reference's for
every registered simulated cache, including a stride that does not tile
the array (the ``np.resize`` stream) and a custom index stream. The torch
``BatchCache`` is held to the reference's ``BatchCache`` (JAX on the CPU)
and to the per-access ``Cache`` on its scan path (the plain version of the
CUDA kernel here), to the reference's closed forms, and, on stochastic
lanes, to the way probabilities within the profile diff's tolerance. Blind
inference, the latency spectrum and whole profiles must equal the
reference's, and the profiles must diff clean against the committed
``experiments/profiles``. Tests marked ``gpu`` hold the scan kernel to its
plain version on the card and skip here.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import devices as jdevices
from repro.core import inference as jinference
from repro.core import pchase as jpchase
from repro.core import spectrum as jspectrum
from repro.core import trace as jtrace
from repro.core import tracecache as jtracecache
from repro.core.cachesim import Cache as JCache
from repro.core.cachesim import CacheGeometry as JCacheGeometry
from repro.core.cachesim import ReplacementPolicy as JReplacementPolicy
from repro.core.cachesim_jax import BatchCache as JBatchCache
from repro.profile import pipeline as jpipeline
from repro_torch.core import cachesim, devices, inference, pchase, spectrum
from repro_torch.core import trace, tracecache
from repro_torch.core.cachesim import CacheGeometry, ReplacementPolicy
from repro_torch.core.cachesim_torch import TORCH_ENGINE_VERSION, BatchCache
from repro_torch.kernels import batch_cache, cases, ref
from repro_torch.profile import diffing, pipeline, store

ROOT = Path(__file__).resolve().parents[1]
GPUS = ("GTX560Ti", "GTX780", "GTX980", "TeslaV100")
SIM = sorted(devices.SIM_CACHES)
DETERMINISTIC = [n for n in SIM
                 if devices.SIM_CACHES[n]().geom.replacement.kind
                 in ("lru", "fifo")]

_CUSTOM_GEOMS = [      # the lru/fifo geometries of the reference's tests
    CacheGeometry("lru_uniform", 32, (4,) * 8),
    CacheGeometry("fifo_uniform", 64, (2,) * 16,
                  replacement=ReplacementPolicy("fifo")),
    CacheGeometry("lru_unequal", 32, (1, 3, 5, 2)),
    CacheGeometry("fifo_unequal", 32, (2, 7, 1, 4),
                  replacement=ReplacementPolicy("fifo")),
]
_STOCHASTIC_GEOMS = [
    CacheGeometry("rand_uniform", 32, (4,) * 4,
                  replacement=ReplacementPolicy("random")),
    CacheGeometry("prob_skewed", 32, (4,) * 4,
                  replacement=ReplacementPolicy(
                      "prob", (1 / 6, 1 / 2, 1 / 6, 1 / 6))),
    CacheGeometry("prob_flat", 32, (3,) * 8,
                  replacement=ReplacementPolicy("prob", (0.6, 0.25, 0.15))),
]


def _jgeom(g: CacheGeometry):
    """The reference's geometry of the same structure: a registered one
    from the reference's registry (set maps included), a custom one
    rebuilt (modulo sets)."""
    if g.name in jdevices.SIM_CACHES:
        return jdevices.SIM_CACHES[g.name]().geom
    assert g.set_map is None
    return JCacheGeometry(g.name, g.line_bytes, tuple(g.way_counts),
                          replacement=JReplacementPolicy(
                              g.replacement.kind, g.replacement.way_probs))


def _mixed(geom, rng) -> np.ndarray:
    """The reference tests' "mixed" stream: a fitting chase, random
    addresses and a thrashing chase, 1,600 accesses."""
    c, b = geom.size_bytes, geom.line_bytes
    fit = (np.arange(600, dtype=np.int64) * b) % c
    thrash = (np.arange(600, dtype=np.int64) * b) % (c + 4 * b)
    rand = np.asarray(rng.integers(0, 4 * c, size=400), dtype=np.int64)
    return np.concatenate([fit, rand, thrash])


def _oracle_hits(geom, addrs) -> np.ndarray:
    c = JCache(_jgeom(geom))
    return np.fromiter((c.access(int(a)) for a in addrs), dtype=bool,
                       count=len(addrs))


# ---------------------------------------------------------------------------
# the backends' traces
# ---------------------------------------------------------------------------


def _cases(name):
    """(array bytes, stride bytes, passes) chases and one custom index
    stream for a structure: beyond and within capacity, and a stride that
    does not tile the array."""
    g = devices.SIM_CACHES[name]().geom
    c, b = g.size_bytes, g.line_bytes
    big = c + b
    odd = 7 * b if big % (7 * b) else 5 * b
    chases = [(big, b, 4), (c // 2, b, 2), (big, odd, 3)]
    rng = np.random.default_rng(len(name))
    custom = rng.integers(0, 2 * c // 4, size=300).astype(np.int64)
    return chases, custom


def _trace_tuple(tr):
    return (np.asarray(tr.indices), np.asarray(tr.latencies),
            np.asarray(tr.meta["true_miss"]))


@pytest.fixture(scope="module")
def reference_traces():
    out = {}
    for name in SIM:
        be = jpchase.cache_backend(jdevices.SIM_CACHES[name],
                                   engine="vector")
        chases, custom = _cases(name)
        for n, s, passes in chases:
            out[(name, n, s)] = _trace_tuple(jpchase.fine_grained(
                be, n, s, passes=passes, warmup_passes=2))
        cfg = jtrace.PChaseConfig(4 * len(custom), 4, len(custom), 4, 0)
        out[(name, "custom")] = _trace_tuple(be(cfg, indices=custom))
    return out


@pytest.mark.parametrize("engine", ["vector", "reference", "torch"])
@pytest.mark.parametrize("name", SIM)
def test_backend_traces_bit_exact(reference_traces, name, engine):
    kw = {"device": "cpu"} if engine == "torch" else {}
    be = pchase.cache_backend(devices.SIM_CACHES[name], engine=engine, **kw)
    chases, custom = _cases(name)
    for n, s, passes in chases:
        got = _trace_tuple(pchase.fine_grained(be, n, s, passes=passes,
                                               warmup_passes=2))
        for g, w in zip(got, reference_traces[(name, n, s)]):
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {n} {s}")
    cfg = trace.PChaseConfig(4 * len(custom), 4, len(custom), 4, 0)
    got = _trace_tuple(be(cfg, indices=custom))
    for g, w in zip(got, reference_traces[(name, "custom")]):
        np.testing.assert_array_equal(g, w, err_msg=f"{name} custom")


def test_non_tiling_stride_is_the_resized_pass():
    """The simulator backends record ``np.resize`` of one pass, which
    restarts at 0 where a real chase would wrap (ROADMAP queue 3): the
    port keeps the reference's stream."""
    cfg = trace.PChaseConfig(100 * 4, 7 * 4, 40, 4, 1)
    warm, rec = pchase._chase_streams(cfg, None)
    jwarm, jrec = jpchase._chase_streams(
        jtrace.PChaseConfig(100 * 4, 7 * 4, 40, 4, 1), None)
    np.testing.assert_array_equal(warm, jwarm)
    np.testing.assert_array_equal(rec, jrec)
    assert rec[15] == 0 and rec[14] == 98


def test_torch_backend_batch_and_lean_paths_match_run():
    mk = devices.SIM_CACHES["maxwell_unified_l1"]
    g = mk().geom
    run = pchase.cache_backend(mk, engine="torch", device="cpu")
    assert run.engine == "torch"
    c, b = g.size_bytes, g.line_bytes
    cfgs = []
    for n in (c // 2, c + b, c + 9 * b):
        iters = int(np.ceil(2.0 * (n // 4) / (b // 4)))
        cfgs.append(trace.PChaseConfig(n, b, iters, 4, 2))
    odd = trace.PChaseConfig(c + b, 3 * b, 200, 4, 2)
    custom = np.resize(np.arange(97, dtype=np.int64) * 8, 97 * 3)
    ccfg = trace.PChaseConfig(4 * len(custom), 4, len(custom), 4, 0)
    traces = run.batch([(cfg, None) for cfg in cfgs]
                       + [(odd, None), (ccfg, custom)])
    for cfg, tr in zip(cfgs + [odd], traces):
        np.testing.assert_array_equal(run(cfg).latencies, tr.latencies)
    np.testing.assert_array_equal(run(ccfg, indices=custom).latencies,
                                  traces[-1].latencies)
    lean = run.steady_misses(cfgs + [odd])
    for cfg, v in zip(cfgs, lean):
        assert v == inference._per_pass_misses(run(cfg))
    assert lean[-1] is None                  # the stride does not tile


def test_stochastic_torch_backend_delegates_to_vector():
    mk = devices.SIM_CACHES["fermi_l1_data"]
    run = pchase.cache_backend(mk, engine="torch", device="cpu")
    assert not hasattr(run, "steady_misses")
    g = mk().geom
    vec = pchase.fine_grained(pchase.cache_backend(mk), g.size_bytes + 128,
                              128, passes=8)
    np.testing.assert_array_equal(
        pchase.fine_grained(run, g.size_bytes + 128, 128,
                            passes=8).latencies, vec.latencies)


@pytest.mark.parametrize("gpu", GPUS)
def test_hierarchy_backend_traces_bit_exact(gpu):
    """The full-hierarchy backend (caches, TLBs, page table) on a chase
    through L1 and a custom index stream."""
    be = pchase.hierarchy_backend(lambda: devices.make_hierarchy(gpu))
    jbe = jpchase.hierarchy_backend(lambda: jdevices.make_hierarchy(gpu))
    got = pchase.fine_grained(be, 16 << 10, 128, passes=2)
    want = jpchase.fine_grained(jbe, 16 << 10, 128, passes=2)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.latencies, want.latencies)
    assert got.meta["patterns"] == want.meta["patterns"]
    idx = np.random.default_rng(2).integers(0, 1 << 14, 64).astype(np.int64)
    got = be(trace.PChaseConfig(64 << 10, 4, 64, 4, 0), indices=idx)
    want = jbe(jtrace.PChaseConfig(64 << 10, 4, 64, 4, 0), indices=idx)
    np.testing.assert_array_equal(got.latencies, want.latencies)


# ---------------------------------------------------------------------------
# BatchCache: the scan's plain version, the closed forms, the lanes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scan_lanes():
    """One heterogeneous batch of every lru/fifo geometry (custom and
    registered), its mixed stream, the torch scan (plain, on the CPU) and
    the reference BatchCache's scan."""
    rng = np.random.default_rng(11)
    geoms = _CUSTOM_GEOMS + [devices.SIM_CACHES[n]().geom
                             for n in DETERMINISTIC]
    streams = [_mixed(g, rng) for g in geoms]
    got = BatchCache(geoms, device="cpu").simulate(streams, force_scan=True)
    want = JBatchCache([_jgeom(g) for g in geoms]).simulate(
        streams, force_scan=True)
    return dict(zip((g.name for g in geoms),
                    zip(geoms, streams, got, want)))


@pytest.mark.parametrize("name", [g.name for g in _CUSTOM_GEOMS]
                         + DETERMINISTIC)
def test_scan_matches_reference_and_oracle(scan_lanes, name):
    geom, addrs, got, want = scan_lanes[name]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle_hits(geom, addrs))


@pytest.mark.parametrize("geom", _CUSTOM_GEOMS, ids=lambda g: g.name)
def test_closed_form_matches_reference(geom):
    c, b = geom.size_bytes, geom.line_bytes
    sim, jsim = BatchCache([geom], device="cpu"), JBatchCache([_jgeom(geom)])
    for n in (c // 2, c + b, c + 5 * b):
        pattern = (np.arange(n // b, dtype=np.int64) * b) % n
        for got, want in zip(sim.periodic_masks(0, pattern),
                             jsim.periodic_masks(0, pattern)):
            np.testing.assert_array_equal(got, want)
        lines = np.arange(n // b, dtype=np.int64) * b
        assert sim.steady_miss_count(0, lines) == jsim.steady_miss_count(
            0, lines)
        stream = np.resize(pattern, 3 * len(pattern))
        np.testing.assert_array_equal(sim.simulate([stream])[0],
                                      jsim.simulate([stream])[0])
    split = np.array([0, b, 0, 2 * b], dtype=np.int64)   # a line in 2 runs
    assert sim.periodic_masks(0, split) is None


def test_closed_form_matches_scan_on_a_cyclic_stream():
    geom = _CUSTOM_GEOMS[2]
    c, b = geom.size_bytes, geom.line_bytes
    stream = np.resize((np.arange((c + b) // b, dtype=np.int64) * b), 60)
    sim = BatchCache([geom], device="cpu")
    np.testing.assert_array_equal(sim.simulate([stream])[0],
                                  sim.simulate([stream], force_scan=True)[0])


def test_prefetch_and_stochastic_closed_forms_rejected():
    with pytest.raises(ValueError, match="prefetch"):
        BatchCache([CacheGeometry("pf", 32, (8,), prefetch_lines=4)],
                   device="cpu")
    with pytest.raises(ValueError, match="prefetch"):
        BatchCache([devices.l2_data(64 << 10).geom], device="cpu")
    sim = BatchCache(_STOCHASTIC_GEOMS, device="cpu")
    for lane, g in enumerate(_STOCHASTIC_GEOMS):
        lines = np.arange(4, dtype=np.int64) * g.line_bytes
        assert sim.steady_miss_count(lane, lines) is None
        assert sim.periodic_masks(lane, lines) is None


def test_engine_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchCache(_CUSTOM_GEOMS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pchase.cache_backend(devices.SIM_CACHES["l1_tlb"], engine="torch")


def _victim_streams(geom, trials: int):
    """Lanes that each fill one set, miss once, and probe the line of one
    way: the probe misses iff the miss evicted that way. Returns the
    streams and each lane's way."""
    m = geom.vector_mapper()
    cand = np.arange(4096, dtype=np.int64) * geom.line_bytes
    same = cand[np.asarray(m(cand)) == int(m(cand[:1])[0])]
    w = geom.way_counts[int(m(cand[:1])[0])]
    fill, extra = same[:w], same[w]
    lanes, ways = [], []
    for way in range(w):
        for _ in range(trials):
            lanes.append(np.concatenate([fill, [extra, fill[way]]]))
            ways.append(way)
    return lanes, np.asarray(ways), w


@pytest.mark.parametrize("geom", _STOCHASTIC_GEOMS
                         + [devices.SIM_CACHES["fermi_l1_data"]().geom],
                         ids=lambda g: g.name)
def test_stochastic_lanes_way_probabilities(geom):
    """Each way's eviction probability, from 1,024 lanes a way, within the
    profile diff's ``WAY_PROB_TOL`` of the policy's."""
    lanes, ways, w = _victim_streams(geom, 1024)
    hits = BatchCache([geom] * len(lanes), device="cpu").simulate(
        lanes, force_scan=True)
    miss = np.array([not h[-1] for h in hits])
    est = [miss[ways == j].mean() for j in range(w)]
    want = (geom.replacement.way_probs[:w]
            if geom.replacement.kind == "prob" else [1 / w] * w)
    assert max(abs(a - b) for a, b in zip(est, want)) <= diffing.WAY_PROB_TOL
    assert all(not h[:w].any() for h in hits)        # the cold fill misses


def test_plain_scan_prob_victim_reads_the_given_weights():
    """Pins the prob victim rule on a hand-made case: the first way whose
    cumulative weight reaches u times the set's total."""
    ways = torch.tensor([[3]], dtype=torch.int32)
    cum = torch.tensor([[0.2, 0.5, 1.0, 1.0]])
    lines = torch.tensor([[0, 1, 2, 3, 0, 2, 1]], dtype=torch.int32)
    sets = torch.zeros_like(lines)
    valid = torch.ones_like(lines, dtype=torch.bool)
    u = torch.tensor([[0.9, 0.9, 0.9, 0.3, 0.0, 0.0, 0.0]])
    hits = ref.batch_cache_ref(ways, torch.tensor([3], dtype=torch.int32),
                               cum, sets, lines, valid, u)
    # line 3 misses in a full set; u 0.3 of the total 1.0 reaches way 1's
    # 0.5 first, so line 1 goes and lines 0 and 2 stay
    assert hits.tolist() == [[False] * 4 + [True, True, False]]


def test_scan_wrapper_checks_its_inputs():
    ins = BatchCache([_CUSTOM_GEOMS[0]], device="cpu").scan_inputs(
        [(0, np.arange(8, dtype=np.int64) * 32)])
    with pytest.raises(ValueError, match="int32"):
        batch_cache.batch_cache_scan(**dict(ins, sets=ins["sets"].long()))
    with pytest.raises(ValueError, match="lanes"):
        batch_cache.batch_cache_scan(**dict(ins, u=ins["u"][:, :3]))
    assert batch_cache.lane_dims(ins["ways"])[0] == (8, 4)


# ---------------------------------------------------------------------------
# blind inference, the spectrum and whole profiles
# ---------------------------------------------------------------------------

_SPECS = {s.sim_name: s for specs in pipeline.DEVICE_STRUCTURES.values()
          for s in specs}


@pytest.fixture(scope="module")
def reference_dissect():
    out = {}
    for name, spec in _SPECS.items():
        out[name] = dataclasses.asdict(jinference.dissect(
            jdevices.sim_cache_backend(name, engine="jax"), n_max=spec.n_max,
            **spec.dissect_kw))
    return out


@pytest.mark.parametrize("name", sorted(_SPECS))
def test_dissect_matches_reference(reference_dissect, name):
    spec = _SPECS[name]
    got = inference.dissect(devices.sim_cache_backend(
        name, engine="torch", device="cpu"), n_max=spec.n_max,
        **spec.dissect_kw)
    assert dataclasses.asdict(got) == reference_dissect[name]


@pytest.mark.parametrize("gpu", GPUS)
def test_measure_spectrum_matches_reference(gpu):
    got = spectrum.measure_spectrum(lambda: devices.make_hierarchy(gpu))
    want = jspectrum.measure_spectrum(lambda: jdevices.make_hierarchy(gpu))
    assert got == want


@pytest.fixture(scope="module")
def reference_profiles():
    return {d: jpipeline.dissect_device(d, engine="vector").to_json()
            for d in GPUS}


def _fields(prof: dict) -> dict:
    return {k: v for k, v in prof.items()
            if k not in ("engine", "engine_version", "timings")}


@pytest.mark.parametrize("engine", ["vector", "torch"])
@pytest.mark.parametrize("gpu", GPUS)
def test_dissect_device_matches_reference(reference_profiles, gpu, engine):
    prof = pipeline.dissect_device(gpu, engine=engine, device="cpu")
    assert _fields(prof.to_json()) == _fields(reference_profiles[gpu])
    assert prof.engine == engine
    assert prof.engine_version == (TORCH_ENGINE_VERSION if engine == "torch"
                                   else cachesim.ENGINE_VERSION)
    assert prof.is_stale() == []
    assert set(prof.timings) >= {"spectrum", "bandwidth", "bank_conflict",
                                 "total"}
    rows = diffing.diff_profiles(prof, store.load_profile(gpu))
    assert [r.field for r in rows if not r.ok] == []
    assert [r.field for r in diffing.diff_profiles(
        prof, pipeline.published_profile(gpu)) if not r.ok] == []


def test_resolve_engine_knows_the_ports_engines():
    assert pipeline.resolve_engine("auto") == "torch"
    assert pipeline.resolve_engine(None) == "torch"
    for e in ("vector", "reference", "torch"):
        assert pipeline.resolve_engine(e) == e
    with pytest.raises(ValueError, match="unknown engine"):
        pipeline.resolve_engine("jax")


def test_tpu_profile_is_the_published_spec():
    prof = pipeline.dissect_device("tpu_v5e", engine="torch", device="cpu")
    assert prof.to_json() == jpipeline.dissect_device(
        "tpu_v5e", engine="vector").to_json()


# ---------------------------------------------------------------------------
# the store's writing half
# ---------------------------------------------------------------------------


def test_save_load_round_trip_and_staleness(tmp_path):
    prof = pipeline.dissect_device("GTX980", engine="torch", device="cpu")
    path = store.save_profile(prof, root=str(tmp_path))
    assert Path(path) == tmp_path / "GTX980.json"
    assert store.load_profile(path).to_json() == prof.to_json()
    assert store.validate_file(path) == []
    prof.engine_version = "trace-engine-torch/0"
    bad = store.save_profile(prof, str(tmp_path / "other" / "GTX980.json"))
    assert any("engine version" in p for p in store.validate_file(bad))
    assert store.load_profile(bad).is_stale()
    with pytest.raises(ValueError, match="names"):
        store.save_profile(prof)


def test_validate_all_committed_root_is_clean():
    got = store.validate_all()
    assert sorted(Path(p).stem for p in got) == sorted(
        p.stem for p in (ROOT / "experiments" / "profiles").glob("*.json"))
    assert all(problems == [] for problems in got.values()), got


# ---------------------------------------------------------------------------
# the trace cache
# ---------------------------------------------------------------------------


def test_trace_cache_keys_separate_the_engines(tmp_path):
    tc = tracecache.TraceCache(str(tmp_path))
    jtc = jtracecache.TraceCache(str(tmp_path))
    cfg = trace.PChaseConfig(4096, 32, 256, 4, 2)
    jcfg = jtrace.PChaseConfig(4096, 32, 256, 4, 2)
    extra = {"backend": "cache", "engine": "vector", "t_hit": 50.0,
             "t_miss_extra": 200.0}
    vec = tc.key("l1_tlb", cfg, extra=extra)
    assert vec == jtc.key("l1_tlb", jcfg, extra=extra)
    tor = tc.key("l1_tlb", cfg, extra=dict(extra, engine="torch"),
                 engine_version=TORCH_ENGINE_VERSION)
    assert tor != vec and tor.startswith("trace-engine-torch-1/")
    assert tracecache.DEFAULT_ROOT == str(ROOT / "build" / "repro_torch"
                                          / "traces")


def test_trace_cache_stays_off_unless_configured(tmp_path):
    code = (
        "import os, sys\n"
        "from repro_torch.core import devices, pchase, tracecache\n"
        "assert tracecache.default_cache() is None\n"
        "be = devices.sim_cache_backend('l1_tlb', engine='torch', "
        "device='cpu')\n"
        "pchase.fine_grained(be, 64 << 20, 2 << 20)\n"
        "print(sorted(os.listdir('.')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TRACE_CACHE_DIR=str(tmp_path / "jax_traces"))
    env.pop("REPRO_TORCH_TRACE_CACHE_DIR", None)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_torch_traces_are_stored_under_their_own_engine(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(tracecache, "_default", None)
    monkeypatch.setattr(tracecache, "_configured", False)
    tc = tracecache.configure(str(tmp_path))
    mk = devices.SIM_CACHES["l1_tlb"]
    cfg = trace.PChaseConfig(34 << 20, 2 << 20, 40, 4, 2)
    tor = pchase.cache_backend(mk, engine="torch", device="cpu",
                               trace_id="l1_tlb")
    first = tor(cfg)
    assert sorted(os.listdir(tmp_path)) == ["trace-engine-torch-1"]
    vec = pchase.cache_backend(mk, engine="vector", trace_id="l1_tlb")
    hits = tc.hits
    np.testing.assert_array_equal(vec(cfg).latencies, first.latencies)
    assert tc.hits == hits                   # not served the torch trace
    assert sorted(os.listdir(tmp_path)) == ["trace-engine-2",
                                            "trace-engine-torch-1"]
    np.testing.assert_array_equal(tor(cfg).latencies, first.latencies)
    assert tc.hits == hits + 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch sees no CUDA device)")


@pytest.mark.gpu
@pytest.mark.parametrize("streams", ["mixed", "probes"])
def test_scan_kernel_matches_plain_on_card(streams):
    """In one heterogeneous batch, one launch, exact: ``mixed``, every
    registered geometry, the custom ones and the stochastic ones on the
    reference tests' stream; ``probes``, two lanes of every registered
    geometry on the streams ``chip_smoke.py`` times
    (:func:`cases.scan_streams`). The plain version holds the first 4,096
    accesses; the lru/fifo lanes equal the reference's Cache."""
    _card()
    rng = np.random.default_rng(5)
    if streams == "mixed":
        geoms = ([devices.SIM_CACHES[n]().geom for n in SIM]
                 + _CUSTOM_GEOMS + _STOCHASTIC_GEOMS)
        lanes = [(i, _mixed(g, rng)) for i, g in enumerate(geoms)]
    else:
        geoms = [devices.SIM_CACHES[n]().geom for n in SIM for _ in range(2)]
        lanes = list(enumerate(cases.scan_streams(geoms[::2], seed=3)))
    ins = BatchCache(geoms, device="cuda").scan_inputs(lanes)
    before = batch_cache.launches
    got = batch_cache.batch_cache_scan(**ins)
    assert batch_cache.launches == before + 1
    plain = cases.SCAN_PLAIN_STEPS
    short = {k: v[:, :plain].contiguous()
             if k in ("sets", "lines", "valid", "u") else v
             for k, v in ins.items()}
    assert torch.equal(got[:, :plain], ref.batch_cache_ref(**short))
    hits = got.cpu().numpy()
    for (i, addrs), g in zip(lanes, geoms):
        if g.replacement.kind in ("lru", "fifo"):
            np.testing.assert_array_equal(hits[i, :len(addrs)],
                                          _oracle_hits(g, addrs))


@pytest.mark.gpu
def test_scan_kernel_refuses_a_lane_too_wide_for_shared_memory():
    _card()
    wide = CacheGeometry("wide", 32, (1024,) * 64)
    sim = BatchCache([wide], device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        sim.simulate([np.arange(64, dtype=np.int64) * 32], force_scan=True)
