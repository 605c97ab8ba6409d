"""Beyond-paper: the fleet's chaos tier under a verified fault campaign.

``repro.serve.faults`` injects seeded faults — replica death mid-decode,
page-table corruption, latency-spike profile degradation — into the
deterministic fleet loop, and the fleet heals through its own machinery:
evacuation + ``_migrate`` re-homing for death, invariant-sweep detection
→ quarantine → readmit for corruption, ``decode_cell_cost`` re-pricing
for degradation.  Every verdict is deterministic accounting (the fleet
consumes no wall clock and exactly one seeded RNG stream):

* **stream integrity**: greedy outputs are schedule-independent, so every
  request that finishes — untouched, migrated, or re-queued — must stream
  byte-identically to the fault-free oracle run;
* **zero leaked pages** after replica death (evacuation is copy-free and
  closed: asserted at kill time, audited again after drain);
* **coverage**: the scripted schedule exercises ≥1 kill and ≥1
  corruption→quarantine→readmit cycle, and outside the campaign no
  invariant ever trips;
* **replay**: an identical seeded campaign replays bit-identically —
  merged decision+fault log, outcome classification, and streams;
* **classification**: every submitted uid ends in exactly one outcome
  class (completed / migrated / requeued / lost / cancelled) — nothing
  is silently dropped.

The port's twin of ``benchmarks/serve_faults.py``. Its weights come from
``_params`` (the port's ``init_params`` seeded 0) on the run's torch
device.
"""

from __future__ import annotations

import time

from repro_torch.bench import Context, Metric, experiment, info
from repro_torch.benchmarks.common import seeded_params as _params


@experiment(
    title="Fleet chaos tier: seeded faults, replay-verified failover",
    section="§5.1+§6.2 applied",
    artifact="beyond-paper",
    devices=("tpu_v5e",),
    tags=("serve", "fleet", "faults", "chaos", "replay", "tpu"),
    expected={
        "Stream integrity": "every finished request streams byte-identically "
                            "to the fault-free oracle, through death and "
                            "quarantine",
        "Leak-free death": "replica death evacuates copy-free; zero pages "
                           "leaked fleet-wide after drain",
        "Coverage": "the campaign exercises >=1 kill and >=1 "
                    "corruption->quarantine->readmit cycle",
        "Replay": "an identical seeded campaign replays bit-identically "
                  "(log, outcomes, streams)",
        "Classification": "every submitted uid lands in exactly one "
                          "outcome class",
    })
def run(ctx: Context) -> list[Metric]:
    import numpy as np

    from repro_torch import configs
    from repro_torch.models.config import ModelConfig
    from repro_torch.serve.faults import (Fault, FaultInjector, OUTCOME_CLASSES,
                                    run_campaign)
    from repro_torch.serve.fleet import FleetEngine

    if ctx.quick:
        cfg = ModelConfig(name="micro", family="dense", num_layers=2,
                          d_model=32, d_ff=64, vocab_size=64, num_heads=2,
                          num_kv_heads=2, dtype="float32",
                          param_dtype="float32")
        n_req, max_slots, max_len = 8, 3, 48
    else:
        cfg = configs.get_smoke_config("granite-8b")
        n_req, max_slots, max_len = 10, 3, 48
    params = _params(cfg, ctx.torch_device)
    rng = np.random.default_rng(ctx.seed)
    work = []
    for _ in range(n_req):
        plen = int(rng.integers(4, max_len // 4))
        n_new = int(rng.integers(4, max_len // 4))
        work.append((rng.integers(cfg.vocab_size, size=plen)
                     .astype(np.int32), n_new))

    def mk_fleet():
        return FleetEngine(cfg, params, max_slots=max_slots,
                           max_len=max_len, replicas=2, page_len=8,
                           prefill_chunk=16)

    # the fault-free oracle run (same fleet, same workload, no injector)
    t0 = time.perf_counter()
    base = run_campaign(mk_fleet(), work)
    dt_base = time.perf_counter() - t0

    # scripted campaign with guaranteed coverage: degrade early, corrupt
    # a loaded replica (every variant cycles through seeds via ctx.seed),
    # kill the most-loaded replica mid-flight, then recover
    sched = (Fault(2, "degrade", factor=4.0),
             Fault(4, "corrupt", variant=ctx.seed % 3),
             Fault(7, "kill"),
             Fault(10, "recover"))
    t0 = time.perf_counter()
    r1 = run_campaign(mk_fleet(), work, FaultInjector(sched))
    dt_fault = time.perf_counter() - t0
    r2 = run_campaign(mk_fleet(), work, FaultInjector(sched))

    # seeded campaign on top: replay is a pure function of the seed
    seeded = lambda: FaultInjector.campaign(                   # noqa: E731
        ctx.seed + 1, rate=0.10, horizon=80)
    c1 = run_campaign(mk_fleet(), work, seeded())
    c2 = run_campaign(mk_fleet(), work, seeded())

    finished = {u for u, c in r1.outcomes.items()
                if c in ("completed", "migrated", "requeued")}
    streams_ok = all(r1.streams[u] == base.streams[u] for u in finished)
    classified = (sorted(r1.outcomes) == list(range(n_req))
                  and all(c in OUTCOME_CLASSES
                          for c in r1.outcomes.values()))
    ev = r1.event_counts
    metrics = [
        Metric("finished_streams_identical_to_oracle", streams_ok, True,
               cmp="eq",
               detail=f"{len(finished)}/{n_req} finished through "
                      f"kill+corrupt+degrade, byte-for-byte"),
        Metric("pages_leaked_after_replica_death",
               r1.stats["pages_leaked"], 0, cmp="eq",
               detail=f"{r1.stats['deaths']} death(s), audited after "
                      "full drain"),
        Metric("campaign_exercised_kill_and_quarantine",
               ev.get("kill", 0) >= 1 and ev.get("quarantine", 0) >= 1
               and ev.get("readmit", 0) >= 1, True, cmp="eq",
               detail=f"events: {dict(sorted(ev.items()))}"),
        Metric("scripted_replay_bit_identical",
               r1.log == r2.log and r1.outcomes == r2.outcomes
               and r1.streams == r2.streams, True, cmp="eq",
               detail=f"{len(r1.log)} merged decision+fault log entries"),
        Metric("seeded_replay_bit_identical",
               c1.log == c2.log and c1.outcomes == c2.outcomes
               and c1.streams == c2.streams, True, cmp="eq",
               detail=f"seed {ctx.seed + 1}, rate 0.10, "
                      f"events {dict(sorted(c1.event_counts.items()))}"),
        Metric("every_uid_classified", classified, True, cmp="eq",
               detail=f"outcomes: {dict(sorted(r1.outcome_counts().items()))}"),
        Metric("router_margin_violations_under_faults",
               r1.stats["margin_violations"] + c1.stats["margin_violations"],
               0, cmp="eq",
               detail="the margin audit holds under any fault schedule"),
        # fault-campaign behavior: info only
        info("campaign_outcomes",
             " ".join(f"{k}={v}" for k, v in
                      sorted(r1.outcome_counts().items()))),
        info("campaign_fault_events",
             " ".join(f"{k}={v}" for k, v in sorted(ev.items()))),
        info("seeded_campaign_outcomes",
             " ".join(f"{k}={v}" for k, v in
                      sorted(c1.outcome_counts().items()))),
        info("ticks_fault_free", base.stats["ticks"], unit="ticks"),
        info("ticks_under_faults", r1.stats["ticks"], unit="ticks",
             detail="extra ticks = re-homed work re-earning its prefix"),
        info("campaign_wall_ms", round(dt_fault * 1e3, 1), unit="ms",
             us=dt_fault * 1e6,
             detail=f"fault-free run: {dt_base*1e3:.1f} ms; "
                    f"wall time on {ctx.torch_device}"),
    ]
    return metrics
