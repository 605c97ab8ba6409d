"""Beyond-paper: the multi-replica fleet as a consumer of measured profiles.

The fleet router (``repro.serve.fleet``) prices request placement with
the same machinery the single-engine path consumes — ``CellCost.step_s``
against each replica's own device profile, free-page headroom, and the
Little's-law inflight bound — so a heterogeneous TeslaV100 + tpu_v5e
fleet is scheduled by *measured* numbers, not replica count.  Every
verdict below is deterministic accounting (no timings gate anything):

* **N=1 oracle**: a one-replica fleet must reproduce the single paged
  engine token-for-token, request-for-request, on the same tick
  schedule — the fleet layer adds routing, never semantics;
* **heterogeneous correctness**: greedy outputs are schedule-independent,
  so the mixed fleet's streamed tokens must equal the oracle per request;
* **zero page leaks** across every replica after drain;
* **router contract**: no decision ever picks a replica whose predicted
  step cost exceeds the best candidate's by more than the router's own
  margin (audited from the decision log);
* **replay**: an identical second run produces a bit-identical decision
  log — fleet runs are replayable by construction.

Fleet slack / migration / preemption stats ride along as info metrics in
the ``repro.bench/v1`` artifact.

The port's twin of ``benchmarks/serve_fleet.py``. Its weights come from
``_params`` (the port's ``init_params`` seeded 0) on the run's torch
device.
"""

from __future__ import annotations

import time

from repro_torch.bench import Context, Metric, experiment, info
from repro_torch.benchmarks.common import seeded_params as _params


def _run_frontend(fleet_factory, work, cfg):
    """Stream a workload through a fresh fleet; returns tokens + stats."""
    from repro_torch.serve.frontend import FleetFrontend
    fleet = fleet_factory()
    front = FleetFrontend(fleet)
    streamed: dict[int, list[int]] = {}
    t0 = time.perf_counter()
    for uid, (prompt, n_new) in enumerate(work):
        front.submit_blocking(prompt, n_new, uid=uid,
                              on_token=lambda u, t:
                              streamed.setdefault(u, []).append(t))
    front.run()
    dt = time.perf_counter() - t0
    fleet.check_invariants()
    return fleet, streamed, dt


@experiment(
    title="Profile-aware multi-replica serving fleet",
    section="§5.1+§6.2 applied",
    artifact="beyond-paper",
    devices=("tpu_v5e",),
    tags=("serve", "fleet", "routing", "littles-law", "profile", "tpu"),
    expected={
        "N=1 oracle": "a one-replica fleet reproduces the single paged "
                      "engine token-for-token on the same tick schedule",
        "Router contract": "no decision exceeds the best candidate's "
                           "predicted step cost by more than the margin",
        "Replay": "routing decisions replay bit-identically",
        "Accounting": "zero pages leaked across replicas after drain",
    })
def run(ctx: Context) -> list[Metric]:
    import numpy as np

    from repro_torch import configs
    from repro_torch.models.config import ModelConfig
    from repro_torch.profile import published_profile
    from repro_torch.serve.engine import PagedServeEngine, Request
    from repro_torch.serve.fleet import FleetEngine

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
    work = []
    for _ in range(n_req):
        plen = int(rng.integers(3, max_len // 3))
        n_new = int(rng.integers(3, max_len // 3))
        work.append((rng.integers(cfg.vocab_size, size=plen)
                     .astype(np.int32), n_new))

    # single paged engine: the oracle token stream
    paged = PagedServeEngine(cfg, params, max_slots=max_slots,
                             max_len=max_len)
    for uid, (prompt, n_new) in enumerate(work):
        paged.submit(Request(uid, prompt, n_new))
    oracle = {r.uid: r.generated for r in paged.run_to_completion()}
    paged.alloc.check_invariants()

    # N=1 fleet on the same workload
    f1, s1, dt1 = _run_frontend(
        lambda: FleetEngine(cfg, params, max_slots=max_slots,
                            max_len=max_len, replicas=1),
        work, cfg)

    # heterogeneous fleet: measured TeslaV100 profile next to tpu_v5e
    profs = lambda: [published_profile("TeslaV100"),          # noqa: E731
                     published_profile("tpu_v5e")]
    f2, s2, dt2 = _run_frontend(
        lambda: FleetEngine(cfg, params, max_slots=max_slots,
                            max_len=max_len, profiles=profs()),
        work, cfg)
    f2b, _, _ = _run_frontend(
        lambda: FleetEngine(cfg, params, max_slots=max_slots,
                            max_len=max_len, profiles=profs()),
        work, cfg)

    st1, st2 = f1.stats(), f2.stats()
    gen_tokens = sum(len(v) for v in oracle.values())
    metrics = [
        # deterministic accounting -> real verdicts
        Metric("n1_tokens_identical_to_paged_oracle", s1 == oracle, True,
               cmp="eq",
               detail=f"{len(oracle)} requests, {gen_tokens} tokens, "
                      "request-for-request"),
        Metric("n1_tick_schedule_matches_oracle",
               f1.ticks == paged.steps, True, cmp="eq",
               detail=f"fleet {f1.ticks} ticks vs engine {paged.steps}"),
        Metric("hetero_tokens_identical_to_oracle", s2 == oracle, True,
               cmp="eq",
               detail="TeslaV100+tpu_v5e fleet, greedy outputs are "
                      "schedule-independent"),
        Metric("pages_leaked_across_replicas",
               st1["pages_leaked"] + st2["pages_leaked"], 0, cmp="eq"),
        Metric("router_margin_violations",
               len(f1.margin_violations()) + len(f2.margin_violations()),
               0, cmp="eq",
               detail=f"margin={f2.margin:.0%}, audited over "
                      f"{st1['decisions'] + st2['decisions']} decisions"),
        Metric("routing_replay_bit_identical",
               f2.decision_log() == f2b.decision_log(), True, cmp="eq",
               detail=f"{st2['decisions']} decisions, fixed seed "
                      f"{ctx.seed}"),
        # fleet behavior stats: info only
        info("fleet_max_slack_tokens", st2["max_slack_tokens"],
             unit="tokens", detail="max over replicas of per-request "
                                   "page slack"),
        info("fleet_migrations", st2["migrations"]),
        info("fleet_preemptions", st2["preemptions"]),
        info("fleet_peak_pages", st2["peak_pages"],
             detail="summed across replicas"),
        info("tokens_per_s_n1_fleet", round(gen_tokens / max(dt1, 1e-9)),
             unit="tok/s", us=dt1 * 1e6,
             detail=f"wall time on {ctx.torch_device}; pair-run on one "
                    "host"),
        info("tokens_per_s_hetero_fleet",
             round(gen_tokens / max(dt2, 1e-9)),
             unit="tok/s", us=dt2 * 1e6,
             detail=f"wall time on {ctx.torch_device}; pair-run on one "
                    "host"),
    ]
    for p in st2["per_replica"]:
        metrics.append(info(
            f"replica/{p['replica']}",
            f"finished={p['finished']} peak_pages={p['peak_pages']} "
            f"preemptions={p['preemptions']} page_len={p['page_len']}",
            detail=f"inflight_bound={p['inflight_bound']} "
                   f"spec={p['spec']}"))
    return metrics
