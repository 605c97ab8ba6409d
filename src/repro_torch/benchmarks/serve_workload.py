"""Beyond-paper: seeded traffic, SLO accounting and the capacity planner.

The workload tier (``repro.serve.workload`` / ``slo`` / ``planner``)
closes the dissect→deploy loop: seeded scenario traces (chat / rag /
agent / batch under poisson / bursty / diurnal arrivals) drive the fleet
front end, the SLO tracker folds the run into deterministic TTFT/TPOT
percentiles in tick units, and the Little's-law capacity planner is held
to a falsifiable prediction against the simulated fleet.  Every verdict
below is deterministic accounting (no timings gate anything):

* **trace determinism**: every scenario's trace is a pure function of
  its spec — two generations produce bit-identical fingerprints;
* **replay**: the same trace replayed through two fresh fleets yields a
  bit-identical SLO report AND routing decision log;
* **zero leaks, nothing dropped**: after every scenario drains, no
  replica holds a page and every request settled as finished;
* **planner vs simulation**: a fleet built with exactly the planner's
  replica count measures a mean residence within a stated bound of the
  predicted ``W``, and its measured p99 TTFT meets the SLO target the
  plan promised (Little's law ``L = λ·W`` holds exactly by construction
  in the report, so the prediction of W is the honest claim).

The port's twin of ``benchmarks/serve_workload.py``. Its weights come from
``_params`` (the port's ``init_params`` seeded 0) on the run's torch
device.
"""

from __future__ import annotations

import time

from repro_torch.bench import Context, Metric, experiment, info
from repro_torch.benchmarks.common import seeded_params as _params

#: planner honesty bound: |predicted W - measured W| / measured W
RESIDENCE_REL_BOUND = 0.5


@experiment(
    title="Seeded workload traffic, SLO accounting, capacity planner",
    section="§5.1/§6.1 applied",
    artifact="beyond-paper",
    devices=("tpu_v5e",),
    tags=("serve", "workload", "slo", "planner", "littles-law", "tpu"),
    expected={
        "Trace determinism": "every scenario trace is a pure function of "
                             "its spec (bit-identical fingerprints)",
        "Replay": "identical runs give bit-identical SLO reports and "
                  "decision logs",
        "Accounting": "zero pages leaked and zero requests dropped "
                      "across all four scenarios",
        "Planner": "simulated residence within the stated bound of the "
                   "predicted W; measured p99 TTFT meets the SLO target",
    })
def run(ctx: Context) -> list[Metric]:

    from repro_torch import configs
    from repro_torch.models.config import ModelConfig
    from repro_torch.serve.fleet import FleetEngine
    from repro_torch.serve.frontend import FleetFrontend
    from repro_torch.serve.planner import SLOTarget, plan_for_trace
    from repro_torch.serve.workload import (WorkloadSpec, generate_trace,
                                      replay_trace)

    if ctx.quick:
        cfg = ModelConfig(name="micro", family="dense", num_layers=2,
                          d_model=32, d_ff=64, vocab_size=64, num_heads=2,
                          num_kv_heads=2, dtype="float32",
                          param_dtype="float32")
        max_slots, max_len, horizon, rate = 2, 32, 12, 0.4
    else:
        cfg = configs.get_smoke_config("granite-8b")
        max_slots, max_len, horizon, rate = 3, 48, 20, 0.4
    params = _params(cfg, ctx.torch_device)

    def replay_once(trace, replicas):
        fleet = FleetEngine(cfg, params, max_slots=max_slots,
                            max_len=max_len, replicas=replicas)
        front = FleetFrontend(fleet)
        replay_trace(front, trace)
        fleet.check_invariants()
        return front

    # one arrival process per scenario so all three are exercised
    mix = (("chat", "poisson"), ("rag", "bursty"),
           ("agent", "diurnal"), ("batch", "poisson"))
    fingerprints_identical = True
    leaked = dropped = total_requests = 0
    t0 = time.perf_counter()
    scenario_info = []
    chat_trace = batch_trace = None
    for scenario, arrival in mix:
        spec = WorkloadSpec(scenario=scenario, arrival=arrival, rate=rate,
                            horizon=horizon, seed=ctx.seed, max_len=max_len,
                            vocab_size=cfg.vocab_size)
        trace = generate_trace(spec)
        fingerprints_identical &= (generate_trace(spec).fingerprint()
                                   == trace.fingerprint())
        if scenario == "chat":
            chat_trace = trace
        elif scenario == "batch":
            batch_trace = trace
        front = replay_once(trace, replicas=2)
        rep = front.slo.report()
        st = front.fleet.stats()
        leaked += st["pages_leaked"]
        dropped += rep.requests - rep.outcome_counts["finished"]
        total_requests += rep.requests
        scenario_info.append(info(
            f"scenario/{scenario}-{arrival}",
            f"requests={rep.requests} ttft_p99={rep.ttft['p99']:g} "
            f"tpot_p99={rep.tpot['p99']:g} "
            f"concurrency={rep.mean_concurrency:.2f}",
            detail=f"{st['decisions']} decisions, "
                   f"{st['preemptions']} preemptions, "
                   f"peak_pages={st['peak_pages']}"))
    dt_scen = time.perf_counter() - t0

    # replay contract on the chat trace: two fresh fleets, one trace
    fa, fb = replay_once(chat_trace, 2), replay_once(chat_trace, 2)
    slo_identical = fa.slo.report().key() == fb.slo.report().key()
    log_identical = fa.fleet.decision_log() == fb.fleet.decision_log()

    # the planner's falsifiable claim: build the fleet it asked for and
    # measure what it predicted.  Batch (long outputs) is the steady
    # decode regime the W0 + M/M/1-wait model describes; the 0.7
    # utilization target keeps the wait term in its accurate range
    slo = SLOTarget(ttft_p99_ticks=32.0, max_utilization=0.7)
    plan = plan_for_trace(cfg, batch_trace, max_slots=max_slots,
                          max_len=max_len, slo=slo)
    front = replay_once(batch_trace, plan.replicas)
    measured = front.slo.report()
    rel_err = (abs(plan.predicted_residence_ticks
                   - measured.mean_residence_ticks)
               / max(measured.mean_residence_ticks, 1e-9))

    return [
        Metric("trace_fingerprints_bit_identical", fingerprints_identical,
               True, cmp="eq",
               detail=f"{len(mix)} scenario/arrival pairs, seed "
                      f"{ctx.seed}"),
        Metric("slo_report_replay_bit_identical", slo_identical, True,
               cmp="eq", detail="chat trace, two fresh 2-replica fleets"),
        Metric("decision_log_replay_bit_identical", log_identical, True,
               cmp="eq"),
        Metric("pages_leaked_across_scenarios", leaked, 0, cmp="eq",
               detail=f"{total_requests} requests over {len(mix)} "
                      "scenarios"),
        Metric("requests_dropped_across_scenarios", dropped, 0, cmp="eq",
               detail="every submission must settle as finished"),
        Metric("plan_feasible", plan.feasible, True, cmp="eq",
               detail=f"N={plan.replicas} at rho="
                      f"{plan.utilization:.2f} for lambda="
                      f"{plan.arrival_per_tick:.3f}/tick"),
        Metric("planner_residence_rel_error", round(rel_err, 4),
               RESIDENCE_REL_BOUND, cmp="le",
               detail=f"predicted W={plan.predicted_residence_ticks:.1f} "
                      f"vs measured "
                      f"{measured.mean_residence_ticks:.1f} ticks on the "
                      f"planned {plan.replicas}-replica fleet"),
        Metric("measured_ttft_p99_meets_slo", measured.ttft["p99"],
               slo.ttft_p99_ticks, cmp="le", unit="ticks",
               detail="the SLO the plan promised, checked by simulation"),
        info("planner_binding_constraint", plan.replica.binding,
             detail=f"C={plan.replica.concurrency} from slots="
                    f"{plan.replica.max_slots}, inflight_bound="
                    f"{plan.replica.inflight_bound}"),
        info("little_mean_concurrency",
             round(measured.mean_concurrency, 3),
             detail="sum(residence)/makespan = lambda*W, exact by "
                    "construction"),
        info("scenario_wall_ms", round(dt_scen * 1e3),
             unit="ms", us=dt_scen * 1e6,
             detail=f"wall time on {ctx.torch_device}; four scenario "
                    "replays"),
        *scenario_info,
    ]
