"""Memory-model-driven kernel tuning (the paper's payoff, §1: measured
hierarchy parameters → software optimization).

A copy of ``repro/core/autotune.py`` for the port: pure arithmetic over
the resolved TPU spec, which ``repro_torch/benchmarks/profile_roundtrip.py``
holds to a loaded profile artifact.

Given the resolved device profile (VMEM capacity, HBM bandwidth/latency
via Little's law — ``repro_torch.core.profile.resolve_spec``, so a dissected
profile installed by a launcher reaches here without parameter plumbing),
choose BlockSpec tiles analytically:

* flash attention: maximize the q-tile (each q-block re-streams all of K/V,
  so HBM traffic ≈ S_kv·d·2·(S_q/bq)) subject to the working set fitting a
  VMEM fraction and tiles being (8,128)-aligned;
* memcpy: smallest block that keeps latency×bandwidth bytes in flight with
  double buffering.

Every choice returns its predicted traffic so the perf loop can check
hypotheses against measurements.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import profile
from repro_torch.core.littles_law import tpu_min_block_bytes


@dataclasses.dataclass
class FlashPlan:
    block_q: int
    block_k: int
    vmem_bytes: int
    hbm_bytes: float          # predicted traffic for one (head, S×S) tile
    note: str
    spec_name: str = ""       # profile the plan was priced against


def flash_attention_blocks(seq_q: int, seq_k: int, head_dim: int, *,
                           dtype_bytes: int = 2, spec=None,
                           vmem_fraction: float = 0.5) -> FlashPlan:
    spec = profile.resolve_spec(spec)
    budget = int(spec.vmem_bytes * vmem_fraction)
    best: FlashPlan | None = None
    for bq in (128, 256, 512, 1024, 2048):
        if bq > seq_q:
            break
        for bk in (128, 256, 512, 1024, 2048):
            if bk > seq_k:
                break
            # resident: q, k, v tiles (double-buffered), acc f32, scores f32
            vmem = (bq * head_dim * dtype_bytes * 2 +
                    2 * bk * head_dim * dtype_bytes * 2 +
                    bq * head_dim * 4 + bq * bk * 4)
            if vmem > budget:
                continue
            traffic = (seq_q * head_dim * dtype_bytes * 2 +      # q in, o out
                       (seq_q / bq) * seq_k * head_dim * dtype_bytes * 2)
            cand = FlashPlan(bq, bk, vmem, traffic,
                             f"kv re-streamed {seq_q // bq}×", spec.name)
            if best is None or (cand.hbm_bytes, -cand.block_k) < \
                    (best.hbm_bytes, -best.block_k):
                best = cand
    if best is None:
        return FlashPlan(128, 128, 0, float("inf"), "fallback: tiny VMEM",
                         spec.name)
    return best


@dataclasses.dataclass
class MemcpyPlan:
    block_rows: int
    block_bytes: int
    inflight_bytes: int
    note: str
    spec_name: str = ""       # profile the plan was priced against


def memcpy_block(cols: int, *, dtype_bytes: int = 4, spec=None,
                 hbm_latency_s: float | None = None) -> MemcpyPlan:
    spec = profile.resolve_spec(spec)
    need = tpu_min_block_bytes(spec, buffers=2, hbm_latency_s=hbm_latency_s)
    row_bytes = cols * dtype_bytes
    rows = max(spec.sublanes, -(-need // row_bytes))
    rows = -(-rows // spec.sublanes) * spec.sublanes      # (8,·) aligned
    return MemcpyPlan(rows, rows * row_bytes, need,
                      "smallest double-buffered block hiding HBM latency",
                      spec.name)
