"""Beyond-paper: the serving layer as a consumer of the dissection laws.

The paged KV-cache engine (repro.serve) derives its page length from the
paper's models — Little's law prices the gather's per-transfer setup
(§5.1), the bank-conflict row model checks the page row tiles cleanly
(§6.2) — and its admission/accounting is exact bookkeeping.  This
experiment runs the same mixed workload through the dense-slot oracle
engine and the paged engine and reports:

* verdict metrics (deterministic accounting, safe to gate): greedy
  outputs token-identical, page slack bounded by one page, paged peak
  HBM strictly under the dense reservation, zero pages leaked;
* info metrics (wall times on the run's device, NEVER gate verdicts):
  tokens/s for both engines, HBM bytes reserved per generated token,
  page-table overhead, and the page-length rationale table.

The port's twin of ``benchmarks/serve_paging.py``. Its weights come from
``_params`` (the port's ``init_params`` seeded 0) on the run's torch
device.
"""

from __future__ import annotations

import time

from repro_torch.bench import Context, Metric, experiment, info
from repro_torch.benchmarks.common import seeded_params as _params


def _run_workload(engine, reqs):
    for r in reqs:
        engine.submit(r)
    t0 = time.perf_counter()
    finished = engine.run_to_completion()
    dt = time.perf_counter() - t0
    return finished, dt


@experiment(
    title="Paged KV-cache serving sized by the memory laws",
    section="§5.1+§6.2 applied",
    artifact="beyond-paper",
    devices=("tpu_v5e",),
    tags=("serve", "paging", "littles-law", "bank-conflict", "tpu"),
    expected={
        "Token equality": "paged engine reproduces the dense-slot "
                          "engine's greedy outputs token-for-token",
        "HBM law": "reserved HBM tracks generated length to within one "
                   "page per live request (vs max_slots*max_len dense)",
        "Page length": "derived from Little's law + the bank-conflict "
                       "row model, not hard-coded",
    })
def run(ctx: Context) -> list[Metric]:
    import numpy as np

    from repro_torch import configs
    from repro_torch.models.config import ModelConfig
    from repro_torch.serve import paging
    from repro_torch.serve.engine import PagedServeEngine, Request, ServeEngine

    if ctx.quick:
        cfg = ModelConfig(name="micro", family="dense", num_layers=2,
                          d_model=32, d_ff=64, vocab_size=64, num_heads=2,
                          num_kv_heads=2, dtype="float32",
                          param_dtype="float32")
        n_req, max_slots, max_len = 5, 2, 24
    else:
        cfg = configs.get_smoke_config("granite-8b")
        n_req, max_slots, max_len = 8, 3, 48
    params = _params(cfg, ctx.torch_device)
    rng = np.random.default_rng(ctx.seed)

    def reqs():
        out = []
        for uid in range(n_req):
            plen = int(rng.integers(3, max_len // 3))
            n_new = int(rng.integers(3, max_len // 3))
            out.append(Request(uid, rng.integers(cfg.vocab_size, size=plen)
                               .astype(np.int32), n_new))
        return out

    work = reqs()

    def clone(rs):
        return [Request(r.uid, r.prompt, r.max_new_tokens) for r in rs]

    dense = ServeEngine(cfg, params, max_slots=max_slots, max_len=max_len)
    dense_fin, dense_dt = _run_workload(dense, clone(work))

    paged = PagedServeEngine(cfg, params, max_slots=max_slots,
                             max_len=max_len)
    paged_fin, paged_dt = _run_workload(paged, clone(work))
    paged.alloc.check_invariants()

    want = {r.uid: r.generated for r in dense_fin}
    got = {r.uid: r.generated for r in paged_fin}
    identical = set(want) == set(got) and all(got[u] == want[u]
                                              for u in want)
    gen_tokens = sum(len(r.generated) for r in paged_fin)
    bpt = paging.kv_bytes_per_token(cfg)
    dense_bytes = dense.hbm_reserved_bytes()
    paged_peak_bytes = paged.peak_pages * paged.page_len * bpt
    s = paged.stats()

    metrics = [
        # deterministic accounting -> real verdicts
        Metric("greedy_tokens_identical", identical, True, cmp="eq",
               detail=f"{len(want)} requests, {gen_tokens} tokens"),
        Metric("max_page_slack_tokens", s["max_slack_tokens"],
               paged.page_len, cmp="le", tol=0.0, unit="tokens",
               detail="HBM held per request tracks generated length to "
                      "<= 1 page (acceptance bound)"),
        Metric("paged_peak_over_dense_reserved",
               round(paged_peak_bytes / max(1, dense_bytes), 3), 1.0,
               cmp="le", tol=0.0,
               detail=f"peak {paged_peak_bytes} B vs dense "
                      f"{dense_bytes} B for the same workload"),
        Metric("pages_leaked_after_drain",
               paged.alloc.allocated_pages, 0, cmp="eq"),
        # wall times: info only, never gate verdicts
        info("page_len_chosen", paged.page_len, unit="tokens",
             detail="argmin of the Little's-law + bank-conflict score"),
        info("tokens_per_s_dense", round(gen_tokens / max(dense_dt, 1e-9)),
             unit="tok/s", us=dense_dt * 1e6,
             detail=f"wall time on {ctx.torch_device}; pair-run on one "
                    "host"),
        info("tokens_per_s_paged", round(gen_tokens / max(paged_dt, 1e-9)),
             unit="tok/s", us=paged_dt * 1e6,
             detail=f"wall time on {ctx.torch_device}; pair-run on one "
                    "host"),
        info("hbm_bytes_per_token_dense",
             round(dense_bytes / max(1, gen_tokens)), unit="B/tok",
             detail="occupancy-blind max_slots*max_len reservation"),
        info("hbm_bytes_per_token_paged",
             round(paged_peak_bytes / max(1, gen_tokens)), unit="B/tok",
             detail="pages actually in circulation at peak"),
        info("page_table_overhead_bytes", paged.page_table_bytes(),
             unit="B", detail="int32 slot x pages_per_seq table"),
        info("preemptions", s["preemptions"]),
    ]
    for t in paging.page_len_rationale(cfg, expected_tokens=max_len):
        metrics.append(info(
            f"rationale/page_len_{t.page_len}",
            f"score={t.score} gather={t.gather_frac} frag={t.frag_frac} "
            f"table={t.table_frac} conflict_degree={t.conflict_degree}",
            detail=f"row_bytes={t.row_bytes}"))
    return metrics
