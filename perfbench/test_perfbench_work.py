"""The yardstick's arithmetic: percentiles and spreads, FLOPs and bytes
from shapes for both configurations against independent counts, the
readers' MFU, roofline and idle shares, and the trace reduction."""

import json
import math
from pathlib import Path

import pytest

from perfbench import devtrace, readers, stats, work

HERE = Path(__file__).resolve().parent
CFG = {n: json.loads((HERE / "configs" / f"{n}.json").read_text())
       for n in ("granite-8b", "deepseek-v2-lite", "granite-8b-pp2")}


def test_percentile_is_nearest_rank():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == 95
    assert stats.percentile(vals, 100) == 100
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([5, 1, 4, 2, 3], 50) == 3
    with pytest.raises(ValueError):
        stats.percentile([], 95)


@pytest.mark.parametrize("name", sorted(CFG))
def test_parameter_counts_match_the_program(name):
    """The shapes the benchmark counts give the program's own count."""
    from perfbench.manifest import port_config
    from repro_torch.models.transformer import count_params
    cfg = CFG[name]
    c = work.counts(cfg)
    assert c["total"] == count_params(port_config(cfg))
    if cfg["reference"] == "mla_moe":
        # active: the program counts top_k experts a layer, and a router
        # of top_k columns where a token multiplies all 64
        active = count_params(port_config(cfg), active_only=True)
        router = cfg["hidden_size"] * (64 - 6) * cfg["num_hidden_layers"]
        assert (work.active_matmul_weights(cfg) + c["embed"] + c["norms"]
                == active + router)
    else:
        assert work.active_matmul_weights(cfg) == c["total"] - c["embed"] - c["norms"]


def test_granite_counts_by_hand():
    cfg = CFG["granite-8b"]
    d, f, hd, L, v = 4096, 14336, 128, 36, 49152
    per_layer = d * 32 * hd + 2 * d * 8 * hd + 32 * hd * d + 3 * d * f
    assert work.active_matmul_weights(cfg) == L * per_layer + d * v
    assert work.kv_bytes_per_token(cfg) == L * 2 * 8 * hd * 2 == 147456
    assert work.attention_flops_per_pair(cfg) == 4 * 32 * hd


def test_deepseek_counts_by_hand():
    cfg = CFG["deepseek-v2-lite"]
    d, L, h, r, rd, nd, vd = 2048, 27, 16, 512, 64, 128, 128
    attn = d * h * (nd + rd) + d * (r + rd) + r * h * nd + r * h * vd + h * vd * d
    moe = d * 64 + 2 * 3 * d * 1408 + 6 * 3 * d * 1408
    assert work.active_matmul_weights(cfg) == L * (attn + moe) + d * 102400
    assert work.kv_bytes_per_token(cfg) == L * (r + rd) * 2 == 31104
    assert work.attention_flops_per_pair(cfg) == 2 * h * (2 * r + rd)
    assert work.experts_touched(cfg, 64) == pytest.approx(
        64 * (1 - (58 / 64) ** 64))


@pytest.mark.parametrize("name", ["granite-8b", "deepseek-v2-lite"])
def test_serve_tick_against_a_token_by_token_count(name):
    cfg = CFG[name]
    decode, chunks = [1500, 7, 4096], [(512, 1024), (0, 100)]
    flops, nbytes = work.serve_tick(cfg, decode, chunks)
    per_pair = work.attention_flops_per_pair(cfg) * cfg["num_hidden_layers"]
    want = 0.0
    keys = 0
    for ctx in decode + [p + 1 for a, b in chunks for p in range(a, b)]:
        want += 2 * work.active_matmul_weights(cfg) + per_pair * ctx
    assert flops == pytest.approx(want, rel=1e-12)
    tokens = 3 + 512 + 100
    keys = sum(decode) + 1024 + 100
    kv = work.kv_bytes_per_token(cfg)
    c = work.counts(cfg)
    w = (c["shared"] + c["norms"] + work.experts_touched(cfg, tokens)
         * c["expert"] * work.expert_layers(cfg)) * 2
    assert nbytes == pytest.approx(w + tokens * cfg["hidden_size"] * 2
                                   + kv * (keys + tokens))
    assert work.serve_tick(cfg, [], []) == (0.0, 0.0)


def test_train_step_work():
    cfg = CFG["granite-8b-pp2"]
    flops, nbytes = work.train_step(cfg, 2, 4096)
    attn = 3 * 4 * 32 * 128 * 18 * 2 * 4096 * 4097 / 2
    assert flops == pytest.approx(6 * work.active_matmul_weights(cfg) * 8192
                                  + attn)
    assert nbytes == 2 * (2 + 8) * work.counts(cfg)["total"]
    t, bound = work.least_seconds(flops, nbytes)
    assert bound == "flops" and t == pytest.approx(flops / 989e12)
    assert work.least_seconds(1.0, 1e12)[1] == "bytes"


def _serve_records(loop="open"):
    ticks = [{"start": 10.0 + i, "end": 10.5 + i, "decode_ctx": [100] * 4,
              "chunks": [(0, 8)]} for i in range(4)]
    ticks.append({"start": 2.0, "end": 2.5, "decode_ctx": [], "chunks": []})
    return {"kind": "serve", "loop": loop, "config": CFG["granite-8b"],
            "window": (10.0, 14.0), "waited": 100.0, "ticks": ticks,
            "requests": [{"due": 10.0, "admit": 10.5},
                         {"due": 11.0, "admit": None}],
            "trace": {"busy_s": 0.5, "window_s": 2.0,
                      "work": [(1e12, 1e9), (1e9, 3.35e12)]}}


def test_readers_arithmetic():
    rec = _serve_records()
    assert readers.tick_ms(rec) == pytest.approx(500.0)
    flops = work.serve_tick(rec["config"], [100] * 4, [(0, 8)])[0]
    assert readers.serve_mfu(rec) == pytest.approx(
        4 * flops / (2.0 * 989e12) * 100)
    assert readers.roofline(rec) == pytest.approx(
        (1e12 / 989e12 + 1.0) / 0.5 * 100)
    assert readers.idle_share(rec) == pytest.approx(75.0)
    assert readers.queue_ms_p95(rec) == pytest.approx(89000.0)
    rec = {"kind": "train", "config": CFG["granite-8b-pp2"],
           "mix": {"batch": 2, "seq_len": 4096}, "window": (0.0, 10.0),
           "steps": 5}
    f, _ = work.train_step(rec["config"], 2, 4096)
    assert readers.train_mfu(rec) == pytest.approx(5 * f / (10 * 989e12) * 100)


@pytest.mark.parametrize("metric,loop,reads", [
    ("tick_ms.open", "open", True), ("tick_ms.open", "closed", False),
    ("tick_ms.closed", "closed", True), ("serve_mfu.closed", "open", False),
    ("queue_ms_p95", "closed", False), ("device_idle_share.train", "open",
                                        False)])
def test_a_reader_without_its_regime_returns_nothing(metric, loop, reads):
    from perfbench import manifest
    got = manifest.load_reader(metric)(_serve_records(loop))
    assert (got is not None) == reads


class _Ev:
    def __init__(self, name, kind, start_us, dur_us, corr=0):
        self._n, self._k, self._s, self._d, self._c = (name, kind, start_us,
                                                       dur_us, corr)

    def name(self):
        return self._n

    def activity_type(self):
        return self._k

    def device_type(self):
        return "DeviceType.CUDA" if self._k in ("kernel", "gpu_memcpy") else "DeviceType.CPU"

    def start_ns(self):
        return int(self._s * 1000)

    def duration_ns(self):
        return int(self._d * 1000)

    def correlation_id(self):
        return self._c


def test_trace_reduction():
    ev = [_Ev("pb.window", "user_annotation", 0, 1000),
          _Ev("pb.engine_step", "user_annotation", 0, 900),
          _Ev("aten::mm", "cpu_op", 100, 50),
          _Ev("cudaLaunchKernel", "cuda_runtime", 110, 5, 1),
          _Ev("cudaLaunchKernel", "cuda_runtime", 120, 5, 2),
          _Ev("gemm", "kernel", 200, 300, 1),
          _Ev("gemm", "kernel", 400, 200, 2),
          _Ev("copy", "gpu_memcpy", 995, 20, 3),
          _Ev("spin", "kernel", -500, 100, 4)]
    got = devtrace.reduce(ev)
    assert got["window_s"] == pytest.approx(1e-3)
    assert got["busy_s"] == pytest.approx((400 + 5) * 1e-6)
    assert got["device_ops"][0] == ["gemm", pytest.approx(500e-6)]
    gaps = dict(got["idle_gaps"])
    assert gaps["pb.engine_step/no host op"] == pytest.approx(395e-6)
    assert gaps["pb.engine_step/aten::mm"] == pytest.approx(200e-6)
    assert math.isclose(sum(gaps.values()) + got["busy_s"], 1e-3)
    with pytest.raises(devtrace.BlindTrace):
        devtrace.reduce([e for e in ev if e.activity_type() != "kernel"
                         and e.activity_type() != "gpu_memcpy"])


def test_trace_reduction_without_activity_types():
    """Older PyTorch events carry no ``activity_type``: the kind comes from
    the device type and the name, and the device's copy of a ``pb.``
    span is no device work."""
    class Old(_Ev):
        activity_type = None

        def device_type(self):
            return ("DeviceType.CUDA" if self._k.startswith(("kernel", "gpu"))
                    else "DeviceType.CPU")

    ev = [Old("pb.window", "user_annotation", 0, 1000),
          Old("pb.window", "gpu_user_annotation", 0, 1000),
          Old("cudaLaunchKernel", "cuda_runtime", 10, 5, 1),
          Old("gemm", "kernel", 200, 300, 1)]
    got = devtrace.reduce(ev)
    assert got["busy_s"] == pytest.approx(300e-6)
    assert got["missing_launches"] == 0
