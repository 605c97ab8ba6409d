"""Serving launcher of the port: the fixed-batch prefill+decode loop, the
dense or paged continuous-batching engine, or the multi-replica fleet over
a synthetic workload.

  # fixed-batch loop
  python -m repro_torch.launch.serve --arch granite-8b --smoke --batch 4 \
      --prompt-len 64 --gen 32

  # dense-slot continuous batching on a mixed workload
  python -m repro_torch.launch.serve --arch granite-8b --smoke \
      --engine dense --requests 16 --slots 4 --max-len 96

  # paged KV cache (page_len derived from the cost model when --page-len
  # is omitted; --num-pages sizes the pool)
  python -m repro_torch.launch.serve --arch granite-8b --smoke \
      --engine paged --requests 16 --slots 4 --max-len 96 \
      [--page-len 8] [--num-pages 32] [--prefill-chunk 16]

  # profile-aware fleet: N paged replicas behind the cost-model router,
  # each bound to its own device profile, streamed through the front end
  python -m repro_torch.launch.serve --arch granite-8b --smoke \
      --engine fleet --replicas 2 --fleet-profiles tpu_v5e,TeslaV100

  # dissect the named GPU at startup (the port's torch engine, on
  # --device) and bind a replica to the fresh profile
  python -m repro_torch.launch.serve --arch granite-8b --smoke \
      --engine fleet --dissect-on-start GTX980 --requests 8

  # seeded fault campaign, run twice and held to bit-identical replay
  python -m repro_torch.launch.serve --arch granite-8b --smoke \
      --engine fleet --replicas 2 --requests 12 --faults 1

  # a seeded workload trace with TTFT/TPOT percentiles, twice
  python -m repro_torch.launch.serve --arch granite-8b --smoke \
      --engine fleet --replicas 2 --workload chat --workload-replay

  # disaggregated prefill/decode tiers
  python -m repro_torch.launch.serve --arch granite-8b --smoke \
      --engine fleet --replicas 2 --fleet-tiers auto

  # capacity planner: pure accounting, no parameters and no device
  python -m repro_torch.launch.serve --arch granite-8b --smoke --plan \
      --workload rag --fleet-profiles tpu_v5e,TeslaV100

  # the paged pool sharded over a serving mesh (one rank per device:
  # a 1-device mesh runs as it is, N devices under torchrun)
  python -m repro_torch.launch.serve --arch granite-8b --smoke \
      --engine fleet --mesh-shape 1

Twin of ``repro/launch/serve.py``; its fleet lines print what the
reference's print, but for wall times and the dissection engine's name.
It runs on the card unless ``--device cpu`` is given; with no card the
default fails (``--plan`` needs no device).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.models import transformer as T
from repro_torch.profile import install_profile
from repro_torch.serve import paging
from repro_torch.serve.engine import PagedServeEngine, Request, ServeEngine
from repro_torch.serve.fleet import (ROUTER_MARGIN, FleetEngine,
                                     resolve_fleet_profile)
from repro_torch.serve.frontend import FleetFrontend
from repro_torch.train.loop import make_serve_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _batch_loop(cfg, params, args) -> dict:
    """Prefill a seeded batch of prompts, then greedy-decode ``gen - 1``
    steps. Returns the timings and the generated tokens (B, gen)."""
    device = params.embed.device
    max_len = args.prompt_len + args.gen
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(1)
                            ).to(device)
    t0 = time.perf_counter()
    logits, cache = T.prefill(params, cfg, {"tokens": prompts},
                              max_len=max_len)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    serve_step = make_serve_step(cfg)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    out = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        logits, cache = serve_step(params, cache, tok, args.prompt_len + i)
        tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
        out.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0
    gen = torch.cat(out, dim=1).cpu()
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} device={device}")
    print(f"prefill: {t_prefill*1e3:.1f} ms "
          f"({args.batch*args.prompt_len/t_prefill:,.0f} tok/s)")
    print(f"decode:  {t_decode*1e3:.1f} ms "
          f"({args.batch*(args.gen-1)/max(t_decode,1e-9):,.0f} tok/s)")
    print("sample tokens:", gen[0, :16].tolist())
    return {"prefill_s": t_prefill, "decode_s": t_decode, "tokens": gen}


def _parse_mesh(args):
    """``--mesh-shape`` -> a serving mesh (or None): '4' or '2,4', on
    ``--device``'s device type. Too few ranks exit with the message that
    names how many to launch."""
    if not getattr(args, "mesh_shape", None):
        return None
    from repro_torch.launch.mesh import make_serve_mesh
    shape = tuple(int(s) for s in str(args.mesh_shape).split(",") if s)
    try:
        mesh = make_serve_mesh(shape,
                               device_type=torch.device(args.device).type)
    except RuntimeError as e:
        raise SystemExit(f"--mesh-shape {args.mesh_shape}: {e}") from None
    print(f"serve mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
          f"({mesh.size()} devices, {mesh.device_type} backend)")
    return mesh


def _workload(cfg, args) -> list[Request]:
    rng = np.random.default_rng(args.seed)
    reqs = []
    for uid in range(args.requests):
        plen = int(rng.integers(4, max(5, args.max_len // 3)))
        n_new = int(rng.integers(4, max(5, args.max_len // 3)))
        reqs.append(Request(uid, rng.integers(cfg.vocab_size, size=plen)
                            .astype(np.int32), n_new))
    return reqs


def _paged_engine(cfg, params, args, mesh=None) -> PagedServeEngine:
    """The paged engine of ``args`` (its pool on ``mesh`` if one is
    given), with the page-length rationale printed as the JAX launcher
    prints it."""
    eng = PagedServeEngine(cfg, params, max_slots=args.slots,
                           max_len=args.max_len, page_len=args.page_len,
                           num_pages=args.num_pages,
                           prefill_chunk=args.prefill_chunk, mesh=mesh)
    print(f"page_len={eng.page_len} "
          f"({'given' if args.page_len else 'cost-model derived'}), "
          f"pool={eng.alloc.num_pages} pages"
          + (f", gather shards={eng.shards}" if mesh is not None else ""))
    for t in paging.page_len_rationale(cfg, expected_tokens=args.max_len,
                                       shards=eng.shards):
        marker = " <-- chosen" if t.page_len == eng.page_len else ""
        print(f"  candidate {t.page_len:4d}: score={t.score:.4f} "
              f"gather={t.gather_frac:.3f} frag={t.frag_frac:.3f} "
              f"conflict_degree={t.conflict_degree}{marker}")
    return eng


def _engine_run(cfg, params, args, engine=None) -> dict:
    """Drive the dense or paged engine over :func:`_workload` to
    completion. ``engine`` (built by the caller) replaces the one ``args``
    names. Returns the engine, the finished requests and the wall
    seconds."""
    if engine is not None:
        eng = engine
    elif args.engine == "paged":
        eng = _paged_engine(cfg, params, args, _parse_mesh(args))
    else:
        _parse_mesh(args)          # printed, as the reference prints it
        eng = ServeEngine(cfg, params, max_slots=args.slots,
                          max_len=args.max_len)
    reqs = _workload(cfg, args)
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    finished = eng.run_to_completion()
    _sync(eng.device)
    dt = time.perf_counter() - t0
    s = eng.stats()
    toks = sum(len(r.generated) for r in finished)
    print(f"arch={cfg.name} engine={args.engine} requests={len(finished)} "
          f"slots={args.slots} max_len={args.max_len} device={eng.device}")
    print(f"generated {toks} tokens in {s['steps']} ticks, {dt*1e3:.1f} ms "
          f"({toks/max(dt,1e-9):,.0f} tok/s wall)")
    print(f"occupancy={s['avg_batch_occupancy']:.2f}")
    if isinstance(eng, PagedServeEngine):
        print(f"peak pages={s['peak_pages']} "
              f"(dense would reserve {args.slots * args.max_len} tokens; "
              f"peak paged ~= {s['peak_pages'] * eng.page_len}), "
              f"preemptions={s['preemptions']}, "
              f"max slack={s['max_slack_tokens']} tok "
              f"(<= 1 page of {eng.page_len})")
    if finished:
        print("sample tokens:", finished[0].generated[:16])
    return {"engine": eng, "finished": finished, "wall_s": dt}


def _resolve_fleet_profiles(args):
    """Fleet replica profile entries from the CLI.

    ``--fleet-profiles`` passes names/paths through for
    ``resolve_fleet_profile``. ``--dissect-on-start`` instead runs the
    blind dissection pipeline against the named device(s) now, with the
    port's torch engine on ``--device``, and binds replicas to the fresh
    in-memory DeviceProfile objects through the same ``resolve_spec()``
    seam.
    """
    if args.dissect_on_start:
        if args.fleet_profiles:
            raise SystemExit(
                "--dissect-on-start and --fleet-profiles are mutually "
                "exclusive: the first measures the profile the second "
                "would name")
        from repro_torch.profile.pipeline import dissect_device
        profiles = []
        for dev in args.dissect_on_start.split(","):
            t0 = time.perf_counter()
            prof = dissect_device(dev.strip(), seed=args.seed,
                                  device=args.device)
            dt = time.perf_counter() - t0
            measured = sum(1 for c in prof.caches.values()
                           if c.provenance == "measured")
            print(f"dissect-on-start: {prof.device} engine={prof.engine} "
                  f"{measured} structures measured in {dt:.2f}s wall "
                  f"(stage total {prof.timings.get('total', 0.0):.2f}s)")
            profiles.append(prof)
        return profiles
    return args.fleet_profiles.split(",") if args.fleet_profiles else None


def _fleet(cfg, params, args, profiles, mesh=None) -> FleetEngine:
    """The fleet ``args`` names; ``--replicas`` passes through verbatim,
    so a replicas/profiles mismatch reaches the CLI user."""
    return FleetEngine(cfg, params, max_slots=args.slots,
                       max_len=args.max_len, replicas=args.replicas,
                       profiles=profiles, page_len=args.page_len,
                       num_pages=args.num_pages,
                       prefill_chunk=args.prefill_chunk,
                       margin=args.router_margin, mesh=mesh,
                       tiers=args.fleet_tiers)


def _fleet_run(cfg, params, args) -> dict:
    """``--engine fleet``: stream the launcher's workload through the
    front end. Returns the fleet, the handles and the wall seconds."""
    profiles = _resolve_fleet_profiles(args)
    fleet = _fleet(cfg, params, args, profiles, _parse_mesh(args))
    if fleet.tiered:
        print(f"tiers: {fleet.tier_plan.describe()}"
              + (" (auto: profile-ranked)"
                 if args.fleet_tiers == "auto" else ""))
    for r in fleet.replicas:
        shard = (f" gather_shards={r.engine.shards}"
                 if r.mesh is not None else "")
        print(f"replica {r.name}: tier={r.tier} "
              f"page_len={r.engine.page_len} "
              f"pool={r.engine.alloc.num_pages} pages,{shard} "
              f"inflight_bound={r.inflight_bound} "
              f"(spec: {r.spec.hbm_bytes_per_s/1e9:.0f} GB/s HBM, "
              f"{r.spec.peak_bf16_flops/1e12:.1f} TFLOP/s)")
    front = FleetFrontend(fleet)
    t0 = time.perf_counter()
    for r in _workload(cfg, args):
        # tokens accumulate on the StreamHandle; no callback needed here
        front.submit_blocking(r.prompt, r.max_new_tokens, uid=r.uid)
    handles = front.run()
    _sync(params.embed.device)
    dt = time.perf_counter() - t0
    fleet.check_invariants()
    s = fleet.stats()
    toks = sum(len(h.tokens) for h in handles)
    print(f"arch={cfg.name} engine=fleet replicas={len(fleet.replicas)} "
          f"requests={s['finished']} slots={args.slots}/replica "
          f"max_len={args.max_len}")
    print(f"streamed {toks} tokens in {s['ticks']} fleet ticks, "
          f"{dt*1e3:.1f} ms ({toks/max(dt,1e-9):,.0f} tok/s wall)")
    print(f"router: {s['decisions']} decisions, "
          f"{s['migrations']} migrations, {s['preemptions']} preemptions, "
          f"margin violations={len(fleet.margin_violations())}")
    if fleet.tiered:
        print(f"handoffs: {s['handoffs']} completed, "
              f"{s['handoff_aborts']} aborted, "
              f"{s['in_transit']} in transit at drain")
    print(f"pages: peak={s['peak_pages']} leaked={s['pages_leaked']} "
          f"max slack={s['max_slack_tokens']} tok")
    for p in s["per_replica"]:
        print(f"  {p['replica']}: finished={p['finished']} "
              f"steps={p['steps']} peak_pages={p['peak_pages']} "
              f"preemptions={p['preemptions']}")
    if handles:
        print("sample stream:", handles[0].tokens[:16])
    return {"fleet": fleet, "handles": handles, "wall_s": dt}


def _mk_trace(cfg, args):
    from repro_torch.serve.workload import WorkloadSpec, generate_trace
    spec = WorkloadSpec(scenario=args.workload, arrival=args.arrival,
                        rate=args.rate, horizon=args.horizon,
                        seed=args.seed, max_len=args.max_len,
                        vocab_size=cfg.vocab_size)
    trace = generate_trace(spec)
    st = trace.stats()
    print(f"workload: {spec.scenario}/{spec.arrival} seed={spec.seed} -> "
          f"{st['requests']} requests / {st['sessions']} sessions over "
          f"{st['span_ticks']} ticks (lambda={st['arrival_per_tick']:.3f}, "
          f"mean prompt={st['mean_prompt']:.1f}, "
          f"mean new={st['mean_new']:.1f})")
    return trace


def _plan(cfg, args):
    """``--plan``: the capacity planner, pure accounting with no
    parameters and no device. Ranks every candidate profile."""
    from repro_torch.serve.planner import SLOTarget, plan_tiers, rank_profiles
    trace = _mk_trace(cfg, args)
    st = trace.stats()
    if not st["requests"]:
        raise SystemExit("empty trace: raise --rate or --horizon")
    profiles = (args.fleet_profiles.split(",") if args.fleet_profiles
                else [args.profile])
    kw = dict(arrival_per_tick=st["arrival_per_tick"],
              mean_prompt=st["mean_prompt"], mean_new=st["mean_new"],
              max_slots=args.slots, max_len=args.max_len,
              slo=SLOTarget(ttft_p99_ticks=args.slo_ttft),
              page_len=args.page_len, num_pages=args.num_pages,
              prefill_chunk=args.prefill_chunk)
    plans = rank_profiles(cfg, profiles, **kw)
    for i, plan in enumerate(plans):
        tag = "best" if i == 0 else f"option {i + 1}"
        print(f"-- {tag}: {plan.replica.spec_name} --")
        for ln in plan.lines():
            print(f"  {ln}")
    if args.fleet_tiers is not None:
        print("-- disaggregated (per-tier) --")
        for ln in plan_tiers(cfg, profiles, **kw).lines():
            print(f"  {ln}")
    return plans


def _workload_run(cfg, params, args) -> dict:
    """``--workload SCENARIO``: replay a seeded trace through the fleet
    front end, report the SLO tracker's percentiles, and hold the
    planner's residence prediction up against the measurement. With
    ``--workload-replay`` the whole thing runs twice on fresh fleets and
    exits 1 on any divergence (trace bytes, SLO report, decision log)."""
    from repro_torch.serve.planner import SLOTarget, plan_for_trace
    from repro_torch.serve.workload import generate_trace, replay_trace

    profiles = _resolve_fleet_profiles(args)
    mesh = _parse_mesh(args)
    trace = _mk_trace(cfg, args)

    def run_once():
        front = FleetFrontend(_fleet(cfg, params, args, profiles, mesh))
        replay_trace(front, trace)
        front.fleet.check_invariants()
        return front

    t0 = time.perf_counter()
    front = run_once()
    _sync(params.embed.device)
    dt = time.perf_counter() - t0
    rep = front.slo.report()
    s = front.fleet.stats()
    print(f"arch={cfg.name} engine=fleet replicas={len(front.fleet.replicas)}"
          f" slots={args.slots}/replica max_len={args.max_len} "
          f"({dt * 1e3:.0f} ms wall)")
    for ln in rep.lines():
        print(ln)
    print(f"router: {s['decisions']} decisions, {s['migrations']} "
          f"migrations, {s['preemptions']} preemptions; pages: "
          f"peak={s['peak_pages']} leaked={s['pages_leaked']}")
    if front.fleet.tiered:
        print(f"tiers: {s['tiers']} -> {s['handoffs']} handoffs, "
              f"{s['handoff_aborts']} aborted")
    plan = plan_for_trace(
        cfg, trace, spec=resolve_fleet_profile(profiles[0] if profiles
                                               else args.profile),
        max_slots=args.slots, max_len=args.max_len,
        slo=SLOTarget(ttft_p99_ticks=args.slo_ttft),
        page_len=args.page_len, num_pages=args.num_pages,
        prefill_chunk=args.prefill_chunk)
    for ln in plan.lines():
        print(f"plan| {ln}")
    print(f"plan| predicted W={plan.predicted_residence_ticks:.1f} vs "
          f"measured mean residence={rep.mean_residence_ticks:.1f} ticks")
    out = {"front": front, "report": rep, "plan": plan, "wall_s": dt}
    if not args.workload_replay:
        return out
    front2 = run_once()
    failures = []
    if generate_trace(trace.spec).fingerprint() != trace.fingerprint():
        failures.append("trace generation diverged for the same spec")
    if front2.slo.report().key() != rep.key():
        failures.append("SLO report diverged between identical runs")
    if front2.fleet.decision_log() != front.fleet.decision_log():
        failures.append("decision log diverged between identical runs")
    if s["pages_leaked"]:
        failures.append(f"{s['pages_leaked']} pages leaked")
    if failures:
        for f in failures:
            print(f"FAIL: {f}")
        raise SystemExit(1)
    print("workload replay verified: bit-identical trace, SLO report and "
          "decision log across both runs")
    return out


def _fault_campaign(cfg, params, args) -> list:
    """``--faults SEED``: run the seeded campaign twice on identical
    fleets and hold the chaos tier to its replay contract. Returns the
    two campaign reports."""
    from repro_torch.serve.faults import FaultInjector, run_campaign

    profiles = _resolve_fleet_profiles(args)
    mesh = _parse_mesh(args)
    work = [(r.prompt, r.max_new_tokens) for r in _workload(cfg, args)]
    t0 = time.perf_counter()
    reports = [run_campaign(_fleet(cfg, params, args, profiles, mesh), work,
                            FaultInjector.campaign(args.faults,
                                                   rate=args.fault_rate))
               for _ in range(2)]
    _sync(params.embed.device)
    dt = time.perf_counter() - t0
    r = reports[0]
    print(f"arch={cfg.name} engine=fleet campaign seed={args.faults} "
          f"rate={args.fault_rate} requests={args.requests} "
          f"({dt*1e3:.0f} ms for both runs)")
    print(f"fault events: {r.event_counts or '(none fired)'}")
    print(f"outcomes: {r.outcome_counts()}")
    print(f"deaths={r.stats['deaths']} quarantines={r.stats['quarantines']} "
          f"readmits={r.stats['readmits']} degrades={r.stats['degrades']} "
          f"lost={r.stats['lost']}")
    print(f"pages leaked={r.stats['pages_leaked']} "
          f"log entries={len(r.log)}")
    failures = []
    if reports[0].log != reports[1].log:
        failures.append("decision log diverged between identical runs")
    if reports[0].outcomes != reports[1].outcomes:
        failures.append("outcome classification diverged")
    if reports[0].streams != reports[1].streams:
        failures.append("token streams diverged")
    if r.stats["pages_leaked"]:
        failures.append(f"{r.stats['pages_leaked']} pages leaked")
    if len(r.outcomes) != args.requests:
        failures.append(f"{args.requests - len(r.outcomes)} requests "
                        "left unclassified")
    if failures:
        for f in failures:
            print(f"FAIL: {f}")
        raise SystemExit(1)
    print("campaign replay verified: bit-identical log, outcomes and "
          "streams across both runs")
    return reports


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="serving launcher of the PyTorch port: fixed-batch "
                    "loop, dense/paged continuous-batching engines, or the "
                    "multi-replica fleet with the profile-aware router")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--engine", choices=("loop", "dense", "paged", "fleet"),
                    default="loop",
                    help="loop: fixed-batch prefill+decode; dense/paged: "
                         "continuous-batching engines on a mixed workload; "
                         "fleet: N paged replicas behind the profile-aware "
                         "router with the streaming front end")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions of the kernels); --dissect-on-start "
                         "runs its scan here too")
    # fixed-batch loop knobs
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="accepted as the JAX launcher accepts it; "
                         "sampling is greedy")
    # engine knobs
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--page-len", type=int, default=None,
                    help="KV page length; omit to derive it from the cost "
                         "model (littles_law + bankconflict)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="page-pool size; omit for dense-equivalent capacity")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prompt tokens admitted per tick (multiple of "
                         "page_len; default one page)")
    ap.add_argument("--profile", metavar="PATH_OR_DEVICE", default=None,
                    help="dissected DeviceProfile artifact (repro.profile/v1 "
                         "JSON, or a device name under experiments/profiles/) "
                         "that page sizing consumes instead of the built-in "
                         "TPU_V5E constants; tpu-family profiles only, as "
                         "in the JAX package")
    ap.add_argument("--mesh-shape", metavar="N[,M]", default=None,
                    help="shard each paged engine/replica's KV pool over a "
                         "device mesh (launch.mesh.make_serve_mesh) on "
                         "--device: '4' is 4 devices on (model,), '2,4' is "
                         "(data, model); one rank per device, so N devices "
                         "need N ranks (torchrun --nproc-per-node N). Token "
                         "streams are bit-identical across mesh widths")
    # fleet knobs
    ap.add_argument("--replicas", type=int, default=None,
                    help="fleet: number of paged replicas (default 1, or "
                         "the length of --fleet-profiles)")
    ap.add_argument("--fleet-profiles", metavar="P1,P2,...", default=None,
                    help="fleet: one profile per replica: artifact path, "
                         "device name under experiments/profiles/, or a "
                         "registered device's published profile; mixed "
                         "GPU/TPU fleets are supported")
    ap.add_argument("--dissect-on-start", metavar="DEV1,DEV2,...",
                    default=None,
                    help="fleet: blind-dissect the named registered "
                         "device(s) at startup with the port's torch "
                         "engine on --device and bind one replica to each "
                         "fresh profile (mutually exclusive with "
                         "--fleet-profiles)")
    ap.add_argument("--fleet-tiers", metavar="PLAN", default=None,
                    help="fleet: disaggregate prefill/decode: "
                         "'prefill:0,1/decode:2,3' pins replica indices "
                         "per tier, 'auto' ranks replicas by measured "
                         "profile (bandwidth-rich -> prefill, low-latency "
                         "-> decode), 'none'/omitted keeps the symmetric "
                         "fleet; with --plan, also prints the per-tier "
                         "capacity answer")
    ap.add_argument("--faults", type=int, metavar="SEED", default=None,
                    help="fleet: run a seeded fault campaign (kill / "
                         "corrupt / degrade) twice and verify bit-identical "
                         "replay; exits 1 on divergence, leaks, or "
                         "unclassified requests")
    ap.add_argument("--fault-rate", type=float, default=0.05,
                    help="per-tick fault probability for --faults "
                         "campaigns (default 0.05)")
    # workload / SLO / planner knobs
    ap.add_argument("--workload", metavar="SCENARIO", default=None,
                    help="fleet: drive a seeded workload trace (one of "
                         "chat, rag, agent, batch: serve.workload."
                         "SCENARIOS) through the front end and report "
                         "TTFT/TPOT percentiles from the SLO tracker")
    ap.add_argument("--arrival", choices=("poisson", "bursty", "diurnal"),
                    default="poisson",
                    help="workload arrival process (default poisson)")
    ap.add_argument("--rate", type=float, default=0.5,
                    help="workload nominal arrivals per tick (default 0.5)")
    ap.add_argument("--horizon", type=int, default=64,
                    help="workload arrival window in ticks (default 64)")
    ap.add_argument("--workload-replay", action="store_true",
                    help="run the seeded trace twice on fresh fleets and "
                         "exit 1 on any divergence (trace bytes, SLO "
                         "report, decision log)")
    ap.add_argument("--plan", action="store_true",
                    help="capacity planner: smallest replica count per "
                         "candidate profile meeting --slo-ttft at the "
                         "workload's arrival rate; pure accounting, no "
                         "parameters and no device")
    ap.add_argument("--slo-ttft", type=float, default=32.0,
                    help="SLO target: predicted p99 TTFT in ticks "
                         "(default 32)")
    ap.add_argument("--router-margin", type=float, default=None,
                    help="fleet: replicas within this fraction of the best "
                         "predicted step cost compete on page headroom "
                         "(default: serve.fleet.ROUTER_MARGIN)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.router_margin is None:
        args.router_margin = ROUTER_MARGIN
    if args.profile:
        prof = install_profile(args.profile)
        print(f"profile: {prof.summary()}")
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode path")
    if args.workload is not None:
        from repro_torch.serve.workload import SCENARIOS
        if args.workload not in SCENARIOS:
            raise SystemExit(f"unknown --workload {args.workload!r}; "
                             f"one of {', '.join(sorted(SCENARIOS))}")
    if args.plan:
        if args.workload is None:
            args.workload = "chat"
        return _plan(cfg, args)    # pure accounting: no params, no device
    device = resolve_device(args.device)
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device)
    if args.engine == "loop":
        return _batch_loop(cfg, params, args)
    if args.engine == "fleet":
        if args.faults is not None:
            return _fault_campaign(cfg, params, args)
        if args.workload is not None:
            return _workload_run(cfg, params, args)
        return _fleet_run(cfg, params, args)
    return _engine_run(cfg, params, args)


if __name__ == "__main__":
    main()
