"""Beyond-paper: disaggregated prefill/decode tiers priced by the profile.

The tiered fleet (``repro.serve.tiers`` + the two-stage router in
``repro.serve.fleet``) splits replicas into prefill specialists and
decode specialists and moves the KV cache between them as a paged-page
transfer priced by ``min(src, dst)`` measured global-memory bandwidth
plus one worst-endpoint DRAM round trip — Table 7 and the P1–P6 latency
spectrum doing placement.  Every verdict is deterministic accounting:

* **oracle chain**: a single-tier plan (every replica in both tiers)
  must reproduce the symmetric fleet token-for-token on the same tick
  schedule with a bit-identical decision log — the tiered router
  degenerates, never diverges;
* **tiered correctness**: greedy outputs are schedule-independent, so a
  2-tier fleet's streams must equal the symmetric oracle per request;
* **zero pages leaked across handoffs** (export releases, import
  allocates, both ends run allocator invariants);
* **two-stage margin contract**: no admit/migrate (stage 1) or handoff
  (stage 2) decision exceeds the best candidate's predicted cost by
  more than the router margin;
* **two-stage replay**: the merged admit+handoff decision log replays
  bit-identically, scripted AND under a seeded fault campaign;
* **classification under faults**: killing a prefill and a decode
  replica mid-run still classifies every uid.

Handoff counts/aborts ride along as info metrics.

The port's twin of ``benchmarks/serve_tiers.py``. Its weights come from
``_params`` (the port's ``init_params`` seeded 0) on the run's torch
device.
"""

from __future__ import annotations

from repro_torch.bench import Context, Metric, experiment, info
from repro_torch.benchmarks.common import seeded_params as _params


def _stream(fleet):
    from repro_torch.serve.frontend import FleetFrontend
    front = FleetFrontend(fleet)
    streamed: dict[int, list[int]] = {}
    return front, streamed, (lambda u, t: streamed.setdefault(u, [])
                             .append(t))


@experiment(
    title="Disaggregated prefill/decode fleet tiers",
    section="§4+§5.1 applied",
    artifact="beyond-paper",
    devices=("tpu_v5e",),
    tags=("serve", "fleet", "tiers", "handoff", "routing", "profile",
          "tpu"),
    expected={
        "Oracle chain": "a single-tier plan reproduces the symmetric "
                        "fleet token-for-token, tick-for-tick, with a "
                        "bit-identical decision log",
        "Handoff accounting": "zero pages leaked across exports/imports",
        "Two-stage replay": "admit+handoff decisions replay "
                            "bit-identically, scripted and seeded",
        "Classification": "every uid classified when a prefill and a "
                          "decode replica die mid-run",
    })
def run(ctx: Context) -> list[Metric]:
    import numpy as np

    from repro_torch import configs
    from repro_torch.models.config import ModelConfig
    from repro_torch.serve.engine import Request
    from repro_torch.serve.faults import Fault, FaultInjector
    from repro_torch.serve.fleet import FleetEngine

    if ctx.quick:
        cfg = ModelConfig(name="micro", family="dense", num_layers=2,
                          d_model=32, d_ff=64, vocab_size=64, num_heads=2,
                          num_kv_heads=2, dtype="float32",
                          param_dtype="float32")
        n_req, max_slots, max_len = 5, 3, 24
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

    def mk_fleet(tiers=None, replicas=2):
        return FleetEngine(cfg, params, max_slots=max_slots,
                           max_len=max_len, replicas=replicas,
                           page_len=4, tiers=tiers)

    def run_fleet(fleet):
        for uid, (prompt, n_new) in enumerate(work):
            fleet.submit(Request(uid, prompt, n_new))
        out = {r.uid: r.generated for r in fleet.run_to_completion()}
        fleet.check_invariants()
        return out

    # symmetric fleet: the oracle this PR chains onto (itself pinned to
    # the dense engine by benchmarks/serve_fleet.py)
    sym = mk_fleet()
    oracle = run_fleet(sym)

    # single-tier plan: every replica in both tiers -> must degenerate
    n = len(sym.replicas)
    single = mk_fleet(tiers=f"prefill:0,{n - 1}/decode:0,{n - 1}")
    single_out = run_fleet(single)

    # 2-tier fleet: replica 0 prefills, replica 1 decodes
    tiered = mk_fleet(tiers="prefill:0/decode:1")
    tiered_out = run_fleet(tiered)
    tiered_b = mk_fleet(tiers="prefill:0/decode:1")
    run_fleet(tiered_b)

    # seeded fault campaign on a 3-replica tiered fleet, run twice:
    # kill one prefill specialist and one decode specialist mid-run
    def fault_run():
        fleet = FleetEngine(cfg, params, max_slots=max_slots,
                            max_len=max_len, replicas=3, page_len=4,
                            tiers="prefill:0,1/decode:1,2")
        fleet.attach_injector(FaultInjector((
            Fault(tick=3, kind="kill", replica=0),
            Fault(tick=6, kind="kill", replica=2))))
        for uid, (prompt, n_new) in enumerate(work):
            fleet.submit(Request(uid, prompt, n_new))
        fleet.run_to_completion(max_ticks=2000)
        fleet.check_invariants()
        return fleet

    fa, fb = fault_run(), fault_run()
    cls = fa.classify()

    st_sym, st_single, st_tier = sym.stats(), single.stats(), tiered.stats()
    st_fault = fa.stats()
    gen_tokens = sum(len(v) for v in oracle.values())
    leaked = (st_single["pages_leaked"] + st_tier["pages_leaked"]
              + st_fault["pages_leaked"])
    stage1 = [d for d in tiered.decisions if d.kind in ("admit", "migrate")]
    stage2 = [d for d in tiered.decisions if d.kind == "handoff"]
    metrics = [
        Metric("single_tier_tokens_identical_to_symmetric",
               single_out == oracle, True, cmp="eq",
               detail=f"{len(oracle)} requests, {gen_tokens} tokens"),
        Metric("single_tier_tick_schedule_matches",
               single.ticks == sym.ticks, True, cmp="eq",
               detail=f"single-tier {single.ticks} ticks vs symmetric "
                      f"{sym.ticks}"),
        Metric("single_tier_decision_log_bit_identical",
               single.decision_log() == sym.decision_log(), True,
               cmp="eq",
               detail="the tiered router degenerates to the symmetric "
                      "one when no replica is specialized"),
        Metric("tiered_tokens_identical_to_oracle",
               tiered_out == oracle, True, cmp="eq",
               detail=f"{st_tier['handoffs']} KV handoffs en route"),
        Metric("pages_leaked_across_handoffs", leaked, 0, cmp="eq",
               detail=f"{st_tier['handoffs'] + st_fault['handoffs']} "
                      "exports/imports audited"),
        Metric("two_stage_margin_violations",
               len(single.margin_violations())
               + len(tiered.margin_violations())
               + len(fa.margin_violations()), 0, cmp="eq",
               detail=f"{len(stage1)} stage-1 (admit/migrate) + "
                      f"{len(stage2)} stage-2 (handoff) decisions "
                      "audited on the scripted tiered run"),
        Metric("two_stage_replay_scripted",
               tiered.decision_log() == tiered_b.decision_log(), True,
               cmp="eq",
               detail=f"{st_tier['decisions']} decisions incl. "
                      f"{len(stage2)} handoffs"),
        Metric("two_stage_replay_seeded_faults",
               fa.decision_log() == fb.decision_log()
               and fa.classify() == fb.classify(), True, cmp="eq",
               detail="kill prefill@t3 + decode@t6, run twice"),
        Metric("all_uids_classified_under_faults",
               sorted(cls) == list(range(n_req)), True, cmp="eq",
               detail=f"outcomes: "
                      f"{sorted(set(cls.values()))}"),
        info("tiered_handoffs", st_tier["handoffs"]),
        info("tiered_handoff_aborts", st_tier["handoff_aborts"]),
        info("fault_run_handoffs", st_fault["handoffs"]),
        info("symmetric_ticks", st_sym["ticks"]),
        info("tiered_ticks", st_tier["ticks"],
             detail="handoff ticks land in TTFT, so a tiered fleet "
                    "trades latency for specialization"),
    ]
    return metrics
