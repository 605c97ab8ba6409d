"""Beyond-paper: the dissect→deploy loop, closed.

For every simulated GPU — the paper's three plus the held-out Volta
(TeslaV100, Jia et al. 2018), which the blind pipeline was never tuned on
— this experiment dissects a full :class:`~repro_torch.core.profile.
DeviceProfile` from traces alone, diffs it field-by-field against the
published tables (Table 5 structural parameters exactly, Fig 14 latency
classes within tolerance), and proves the artifact survives a JSON
round-trip bit-identically.

On the TPU target it closes the *deploy* half: the profile artifact is
written, re-loaded, and fed to the three downstream consumers —
``serve.paging.choose_page_len``, ``core.autotune.flash_attention_blocks``
and ``costmodel.CellCost.step_s`` — which must (a) reproduce the
constants-path decisions when the profile equals the published spec and
(b) demonstrably *move* when a profile field moves (halving the profile's
HBM bandwidth halves the Little's-law in-flight requirement), proving the
decisions consume the loaded artifact rather than module constants.

The port's twin of ``benchmarks/profile_roundtrip.py``. The GPUs are
dissected by the batched torch engine on the run's torch device. On
GTX980, where that device is a card, the torch engine races the vector
engine; every probe of the search resolves in the torch engine's closed
forms on the host, so the race launches no scan kernel.
"""

from __future__ import annotations

import os
import tempfile

from repro_torch.benchmarks.common import timed
from repro_torch.bench import Context, Metric, experiment, info
from repro_torch import profile as P

GPU_DEVICES = ("GTX560Ti", "GTX780", "GTX980", "TeslaV100")


def _roundtrip(prof) -> bool:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        P.save_profile(prof, path)
        loaded = P.load_profile(path)
        return loaded.to_json() == prof.to_json()
    finally:
        os.unlink(path)


def _gpu_metrics(ctx: Context) -> list[Metric]:
    prof, us = timed(P.dissect_device, ctx.device.name,
                     quick=ctx.quick, seed=ctx.seed, device=ctx.torch_device)
    pub = P.published_profile(ctx.device.name)
    rows = P.diff_profiles(prof, pub)
    checked = [r for r in rows if r.rule != "info"]
    bad = [r for r in checked if not r.ok]
    metrics = [
        Metric("diff_mismatches", len(bad), 0, cmp="eq", us=us,
               detail=f"{len(checked)} checked fields; mismatched: "
                      f"{[r.field for r in bad] or '-'}"),
    ]
    for cls in sorted(pub.latency):
        mv = prof.latency.get(cls)
        metrics.append(Metric(f"latency_{cls}_cycles", mv, pub.latency[cls],
                              cmp="close", tol=0.02, unit="cyc"))
    structural = [r for r in rows
                  if r.rule == "eq" and not r.field.startswith(
                      ("latency/", "bandwidth/", "bank_conflict/"))]
    metrics.append(Metric("structural_fields_exact",
                          sum(r.ok for r in structural), len(structural),
                          cmp="eq",
                          detail="size/line/sets/ways/policy/mapping bits"))
    pc = prof.provenance_counts()
    pub_caches = [n for n, c in prof.caches.items()
                  if c.provenance == "published"]
    # the batched engine made the slow structures cheap, so quick mode
    # measures everything too: "ge" in BOTH modes, and the only cache
    # row left on published fallback is the whole-L2 data array
    metrics.append(Metric("measured_fields", pc["measured"], 10, cmp="ge",
                          detail="published-fallback cache rows: "
                                 f"{pub_caches or '-'}"))
    metrics.append(Metric("quick_measures_data_caches",
                          not [n for n in pub_caches if n != "l2_data"],
                          True, cmp="eq",
                          detail="no structure is skipped in quick mode"))
    metrics.append(Metric("json_roundtrip_identical", _roundtrip(prof),
                          True, cmp="eq"))
    if ctx.device.name == "GTX980":
        metrics.append(_engine_speedup_metric(ctx))
    return metrics


def _engine_speedup_metric(ctx: Context) -> Metric:
    """Race the full blind structure search, vector vs the batched torch
    engine (``resolve_engine("auto")``) on the caller's torch device, the
    CPU included, as the reference races wherever its engine resolves.

    Every probe of the search is a cyclic chase that the torch engine
    resolves in closed form on the host, so the race sets the closed
    forms against the vector engine's chunk stepping and launches no
    scan kernel; the detail counts the scan's launches to show it. The
    trace cache is bypassed so both engines pay for real simulation;
    best-of-2 per engine."""
    from repro_torch.core import tracecache
    from repro_torch.kernels import batch_cache
    from repro_torch.profile.pipeline import dissect_structures, resolve_engine

    dev = ctx.torch_device
    batched = resolve_engine("auto")
    scans = batch_cache.launches
    best: dict[str, float] = {}
    for eng in ("vector", batched):
        runs = []
        for _ in range(2):
            with tracecache.disabled():
                _, us = timed(dissect_structures, ctx.device.name,
                              engine=eng, device=dev)
            runs.append(us)
        best[eng] = min(runs)
    scans = batch_cache.launches - scans
    ratio = best["vector"] / max(best[batched], 1.0)
    return Metric("batched_engine_speedup", round(ratio, 1), 10, cmp="ge",
                  us=best[batched],
                  detail="full blind structure search, trace cache "
                         f"bypassed: vector {best['vector'] / 1e6:.3f}s -> "
                         f"{batched} {best[batched] / 1e6:.3f}s (best of 2; "
                         f"closed forms on the host, {scans} scan launches "
                         f"on {dev})")


def _tpu_metrics(ctx: Context) -> list[Metric]:
    from repro_torch import configs
    from repro_torch.core import autotune, costmodel, littles_law
    from repro_torch.serve import paging

    prof, us = timed(P.dissect_device, ctx.device.name, seed=ctx.seed)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        P.save_profile(prof, path)
        loaded = P.load_profile(path)
    finally:
        os.unlink(path)
    metrics = [Metric("json_roundtrip_identical",
                      loaded.to_json() == prof.to_json(), True, cmp="eq",
                      us=us)]

    cfg = configs.get_smoke_config("granite-8b")
    pl_const = paging.choose_page_len(cfg, expected_tokens=256)
    pl_prof = paging.choose_page_len(cfg, spec=loaded, expected_tokens=256)
    metrics.append(Metric("choose_page_len_from_profile", pl_prof, pl_const,
                          cmp="eq", detail="loaded artifact reproduces the "
                          "constants-path decision"))

    fp_const = autotune.flash_attention_blocks(4096, 4096, 128)
    fp_prof = autotune.flash_attention_blocks(4096, 4096, 128, spec=loaded)
    metrics.append(Metric("flash_blocks_from_profile",
                          f"{fp_prof.block_q}x{fp_prof.block_k}",
                          f"{fp_const.block_q}x{fp_const.block_k}", cmp="eq",
                          detail=f"plan priced against {fp_prof.spec_name!r}"))

    plan = costmodel.ParallelismPlan(dp=1, tp=1)
    cc = costmodel.decode_cell_cost(cfg, global_batch=4, seq=256, plan=plan)
    cc2 = costmodel.decode_cell_cost(cfg, global_batch=4, seq=256, plan=plan)
    metrics.append(Metric("step_s_from_profile", cc2.step_s(loaded),
                          cc.step_s(), cmp="close", tol=1e-9, unit="s"))

    # sensitivity: the decisions must MOVE with the artifact, or they are
    # not consuming it.  Halve the profile's HBM bandwidth: Little's law
    # says the in-flight requirement (and the paging gather setup term)
    # halves with it.
    slow = P.DeviceProfile.from_json(loaded.to_json())
    slow.spec["hbm_bytes_per_s"] = loaded.spec["hbm_bytes_per_s"] / 2
    need = littles_law.tpu_required_inflight_bytes(loaded)
    need_slow = littles_law.tpu_required_inflight_bytes(slow)
    metrics.append(Metric("inflight_scales_with_profile_hbm",
                          round(need / max(need_slow, 1), 4), 2.0,
                          cmp="close", tol=1e-6,
                          detail="halved profile HBM bw halves the "
                          "Little's-law in-flight bytes"))
    metrics.append(info("provenance",
                        f"{prof.provenance_counts()['published']} published "
                        "fields (no on-hardware dissection on this host)"))
    return metrics


@experiment(
    title="DeviceProfile round-trip: blind dissection feeds the consumers",
    section="§4–§6 applied",
    artifact="beyond-paper",
    devices=GPU_DEVICES + ("tpu_v5e",),
    tags=("profile", "pchase", "spectrum", "consumer", "held-out"),
    expected={
        "Structural parameters": "size/line/sets/ways/policy recovered "
                                 "blind match Table 5 (and Jia et al. for "
                                 "the held-out TeslaV100) exactly",
        "Latency classes": "P1–P6 within 2% of the Fig-14 calibration",
        "Artifact": "repro.profile/v1 JSON survives save->load "
                    "bit-identically",
        "Consumers": "choose_page_len, flash_attention_blocks and "
                     "CellCost.step_s reproduce constants-path decisions "
                     "from the loaded artifact and track its fields",
    })
def run(ctx: Context) -> list[Metric]:
    if ctx.device.kind == "tpu":
        return _tpu_metrics(ctx)
    return _gpu_metrics(ctx)
