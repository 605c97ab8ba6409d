"""Generated documentation: serving guide, profile tables, CLI reference.

Twin of ``repro/bench/docsgen.py``. Three docs join the experiment
catalogue (``report.experiments_doc``) under the same contract —
**rendered from the code (or committed artifacts), never written by
hand** — so ``python -m repro_torch.bench docs --check`` fails whenever
any of them drifts from its source. The port writes them under
``build/repro_torch/docs/``, never ``docs/`` (the JAX package's):

* :func:`serving_doc` → ``serving.md``: the serving-layer guide. Prose is
  templated here, the reference's text, but every number in it
  (page-length rationale scores, router margin, scratch-page constant,
  preemption rules, workload scenario tables, a live capacity-plan
  example) is pulled live from ``repro_torch.serve``, so the guide
  cannot mis-state the port's behavior and equals the reference's page
  wherever the two packages agree.
* :func:`profiles_doc` → ``profiles.md``: the measured-vs-published
  verdict table for every committed ``experiments/profiles/*.json``,
  rendered through :mod:`repro_torch.profile.diffing`.
* :func:`cli_doc` → ``cli.md``: every CLI surface of the port
  (``repro_torch.bench`` and the four launchers), walked out of the
  argparse definitions themselves, so flags are documented by their own
  ``help=`` strings.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

GENERATED_BANNER = """\
<!-- GENERATED FILE — do not edit by hand.
     Regenerate with: PYTHONPATH=src python -m repro_torch.bench docs -->
"""


#: the checkout's root: paths under it are written relative to it, so a
#: page renders the same in any checkout
_ROOT = str(Path(__file__).resolve().parents[3]) + os.sep


def _md_escape(v: object) -> str:
    return str(v).replace(_ROOT, "").replace("|", "\\|").replace("\n", " ")


# ---------------------------------------------------------------------------
# docs/serving.md
# ---------------------------------------------------------------------------


def serving_doc() -> str:
    from repro_torch import configs, profile as P
    from repro_torch.serve import engine, faults, fleet, paging, planner, \
        slo, tiers, workload

    cfg = configs.get_config("granite-8b")
    terms = paging.page_len_rationale(cfg, expected_tokens=256)
    chosen = paging.choose_page_len(cfg, expected_tokens=256)
    sharded_rules = sorted(k for k, v in engine.MESH_SERVE_RULES.items()
                           if v is not None)

    lines = [
        "# Serving layer guide",
        "",
        GENERATED_BANNER,
        "The serving stack is a consumer of the paper's dissection laws: "
        "every geometry below (page length, admission bounds, routing "
        "scores) is derived from measured memory-hierarchy parameters, "
        "never hard-coded. This page is generated from the code that "
        "implements it.",
        "",
        "## The four engines",
        "",
        "| Engine | Module | What it is | Use it for |",
        "|---|---|---|---|",
        "| `loop` | `launch/serve.py` | fixed-batch prefill + decode, no "
        "scheduling | kernel-level throughput measurement |",
        "| `dense` | `serve/engine.py::ServeEngine` | continuous batching "
        "over dense `max_slots x max_len` cache slots | the differential "
        "ORACLE: trusted, occupancy-blind |",
        "| `paged` | `serve/engine.py::PagedServeEngine` | continuous "
        "batching over the paged KV cache (`serve/paging.py`) | the real "
        "serving path: HBM tracks generated tokens |",
        "| `fleet` | `serve/fleet.py::FleetEngine` | N paged replicas, "
        "each on its own device profile, behind the cost-model router "
        "with the streaming front end (`serve/frontend.py`) | "
        "multi-replica, heterogeneous serving |",
        "",
        "Each layer is pinned to the previous one by a differential "
        "test: paged reproduces dense token-for-token "
        "(`tests/test_serve_paged_equiv.py`), and an N=1 fleet reproduces "
        "the single paged engine request-for-request on the same tick "
        "schedule (`tests/test_serve_fleet.py`, `serve_fleet` "
        "experiment).",
        "",
        "## Page sizing: the laws, priced",
        "",
        "`paging.choose_page_len` scores every candidate with the "
        "dissection models — the Little's-law gather setup term "
        f"(`GATHER_OUTSTANDING = {paging.GATHER_OUTSTANDING}` outstanding "
        "DMAs), half-page fragmentation, page-table overhead, and the "
        "§6.2 bank-conflict row model (sub-lane-row pages are penalized "
        "by their predicted serialization degree). For `granite-8b` at "
        "256 expected tokens on the active profile:",
        "",
        "| page_len | row bytes | gather | frag | table | conflict "
        "degree | score |",
        "|---:|---:|---:|---:|---:|---:|---:|",
    ]
    for t in terms:
        mark = " **<-- chosen**" if t.page_len == chosen else ""
        lines.append(
            f"| {t.page_len} | {t.row_bytes} | {t.gather_frac} "
            f"| {t.frag_frac} | {t.table_frac} | {t.conflict_degree} "
            f"| {t.score}{mark} |")
    lines += [
        "",
        "A replica constructed with a different device profile re-derives "
        "this table from that profile's measured bandwidth, latency and "
        "lane geometry — the launcher prints the rationale under "
        "`--engine paged`.",
        "",
        "## Mesh-sharded replicas: one replica = one device slice",
        "",
        "`PagedServeEngine(mesh=...)` (and `FleetEngine(mesh=...)`, "
        "`--mesh-shape` on the launcher) lays the paged KV pool out over "
        "a device mesh from `launch/mesh.py::make_serve_mesh`. The split "
        "is deliberately narrow: of the whole rule table, only "
        f"`{sharded_rules}` maps onto a mesh axis "
        f"(`engine.MESH_SERVE_RULES`, heads on `\"model\"` with the GQA "
        "non-divisible fallback); pages, activations and everything else "
        "stay replicated, and the allocator plus page tables never leave "
        "the host. The paged scatter/gather runs under `shard_map`, and "
        "the gather result is constrained back to replicated before any "
        "matmul touches it — so every downstream operand is "
        "width-invariant BY CONSTRUCTION and no cross-width float "
        "reassociation can creep in.",
        "",
        "**Donation contract:** the step functions are jitted with "
        "`donate_argnums` on the cache operand and, under a mesh, "
        "`out_shardings` pinned to the input cache's exact layout, so "
        "XLA aliases every pool shard in place (copy-free update; "
        "`tests/test_serve_donation.py` pins buffers-consumed, a flat "
        "live-buffer count, and the absence of XLA's donation warning).",
        "",
        "**The oracle chain**, each link a differential test:",
        "",
        "```",
        "dense ServeEngine  ==  unsharded paged  ==  1-device mesh  ==  "
        "2/4/8-way mesh",
        "  (trusted)            (paged_equiv)       (serve_sharded)     "
        "(XLA_FLAGS host mesh)",
        "```",
        "",
        "token-for-token on the same tick schedule at every link "
        "(`tests/test_serve_sharded.py`, `serve_sharded` experiment). "
        "Per-shard page pricing: each shard gathers `1/shards` of a row "
        "against its own partition's full bandwidth and latency "
        "(per-partition, not aggregate — arXiv:1804.06826), so "
        "`choose_page_len(shards=N)` re-prices the table above with "
        "thinner rows. For `granite-8b` at 256 expected tokens:",
        "",
        "| shards | chosen page_len | row bytes/shard | gather frac |",
        "|---:|---:|---:|---:|",
    ] + [
        (lambda b: f"| {s} | {b.page_len} | {b.row_bytes} "
                   f"| {b.gather_frac} |")(
            min(paging.page_len_rationale(cfg, expected_tokens=256,
                                          shards=s),
                key=lambda t: (t.score, t.page_len)))
        for s in (1, 2, 4, 8)
    ] + [
        "",
        "## Preemption and seniority",
        "",
        f"* physical pages below `SCRATCH_PAGES = {paging.SCRATCH_PAGES}` "
        "are reserved scratch: inactive batch rows write their garbage "
        "K/V there and can never corrupt live pages;",
        "* when the free list runs dry, the engine preempts the youngest "
        "STRICTLY-younger live request (pages released copy-free, the "
        "request re-queued for a deterministic greedy re-run);",
        "* seniority (`admit_seq`) is assigned once and survives "
        "preemption, so the oldest live request is never a victim and "
        "always makes progress — no livelock, no starvation;",
        "* a preempted request stranded behind a page-dry replica is "
        "MIGRATED by the fleet router to a replica with headroom; it "
        "re-enters that replica's admission order at the back (seniority "
        "is engine-local).",
        "",
        "## Fleet routing policy",
        "",
        "The router scores every replica that can accept the head-of-line "
        "request (`PagedServeEngine.can_accept`: a free slot net of "
        "queued work, plus a first chunk's worth of free pages):",
        "",
        "1. **step cost** — a fresh `decode_cell_cost(...).step_s(spec)` "
        "per (replica, decision), priced against that replica's OWN "
        "profile. One CellCost per decision keeps pricing scoped: a "
        "mixed fleet must never emit `SpecMixWarning`.",
        f"2. **margin filter** — replicas within `ROUTER_MARGIN = "
        f"{fleet.ROUTER_MARGIN:.0%}` of the best predicted step cost are "
        "cost-equivalent; the router NEVER picks outside this band (the "
        "`serve_fleet` experiment audits every decision from the log).",
        "3. **Little's-law inflight bound** — `required_inflight_bytes / "
        "gather_row_bytes` sequences saturate the replica's HBM pipe; "
        "admission past the bound is penalized first.",
        "4. **free-page headroom**, then lowest replica index — the "
        "deterministic tie-break that makes runs replay bit-identically.",
        "",
        "GPU-profile replicas price through "
        "`DeviceProfile.serving_spec()`: measured global bandwidth "
        "(Table 6 / occupancy sweep), the measured P4 DRAM latency as "
        "the Little's-law anchor, and the shared-memory bank count as "
        "the row-tiling lane geometry.",
        "",
        "## Disaggregated prefill/decode tiers",
        "",
        "`--fleet-tiers` (`serve/tiers.py`) splits the fleet into "
        "prefill specialists and decode specialists: prefill is "
        "bandwidth/FLOP-bound (one chunked pass over the prompt), "
        "decode is latency/Little's-law-bound (the whole live cache "
        "re-read every tick), so heterogeneous replicas play to type. "
        "Routing becomes two-stage, both stages on the SAME fleet-global "
        "decision sequence so the merged log still replays "
        "bit-identically:",
        "",
        "1. **stage 1 (admit/migrate)** — prefill-tier candidates, "
        "priced with `prefill_cell_cost` over the whole prompt: "
        "load-independent, memory-bound, so the bandwidth-rich replica "
        "wins the phase it is good at;",
        "2. **KV handoff** — when a prefill specialist finishes a "
        "prompt, its WHOLE pages move: `handoff_bytes = pages × "
        "page_len × kv_bytes_per_token`, priced at `min(src, dst)` "
        "measured global-memory bandwidth plus one worst-endpoint DRAM "
        "round trip (`handoff_seconds`), then quantized against the "
        "destination's decode step (`handoff_ticks`, never 0) — the "
        "first sampled token is withheld in transit, so handoff "
        "latency lands in TTFT, never vanishes between tiers;",
        "3. **stage 2 (handoff placement)** — decode-tier candidates "
        "with import capacity, priced with `decode_cell_cost` at live "
        "load PLUS the per-candidate transfer term, under the same "
        f"`ROUTER_MARGIN = {fleet.ROUTER_MARGIN:.0%}` audit as stage 1.",
        "",
        "`--fleet-tiers auto` ranks replicas by measured profile — "
        "normalized global bandwidth minus normalized P4 DRAM latency "
        "(`tiers.auto_tiers`); the top half prefills. For the committed "
        "profiles:",
        "",
        "| device | global BW (GB/s) | DRAM latency (µs) | auto tier |",
        "|---|---:|---:|---|",
    ] + (lambda specs, plan: [
        f"| {s.name} | {s.hbm_bytes_per_s / 1e9:.0f} "
        f"| {s.hbm_latency_s * 1e6:.3g} "
        f"| {'prefill' if i in plan.prefill else 'decode'} |"
        for i, s in enumerate(specs)
    ])(*(lambda specs: (specs, tiers.auto_tiers(specs)))(
        [P.published_profile(d).serving_spec()
         for d in ("GTX980", "TeslaV100", "tpu_v5e")])) + [
        "",
        "A single-tier plan (every replica in both tiers) degenerates "
        "to the symmetric router bit-for-bit — tokens, tick schedule "
        "and decision log — extending the oracle chain to "
        "dense → paged → fleet → tiered fleet "
        "(`tests/test_serve_tiers.py`, `serve_tiers` experiment). "
        "`export_pages`/`import_pages` move the cache token-major, so "
        "tiers may disagree about `page_len`; allocator invariants run "
        "on both ends and no stream is ever resident in two tiers' "
        "page tables at once. Killing a replica mid-handoff aborts the "
        "transfer deterministically: the request re-enters the prefill "
        "tier and classifies `requeued`/`migrated`, never lost "
        "silently. `planner.plan_tiers` answers the sizing question "
        "per tier — how many prefill vs decode replicas of which "
        "profile — with the handoff folded into predicted TTFT.",
        "",
        "## Streaming front end",
        "",
        "`serve/frontend.py::FleetFrontend` drives one deterministic "
        "event loop (no wall clock, no RNG): each tick dispatches, ticks "
        "every replica in index order, migrates stranded rollbacks, then "
        "drains new tokens to per-request callbacks in uid order. "
        "Preempted requests re-earn their already-streamed prefix "
        "silently (greedy re-runs are identical), so subscribers see one "
        "continuous stream. `submit` raises `Backpressure` when the "
        "bounded queue is full — which only happens when every replica "
        "is page-saturated.",
        "",
        "## Chaos tier: faults, quarantine, replay",
        "",
        "`serve/faults.py::FaultInjector` runs seeded or scripted fault "
        "campaigns against the fleet; every transition is a `FaultEvent` "
        "on the SAME fleet-global sequence as routing decisions, so "
        "`FleetEngine.decision_log()` replays bit-identically under any "
        "fault schedule (`serve_faults` experiment, "
        "`tests/test_serve_faults.py`).",
        "",
        "Injectable fault kinds "
        f"(`faults.FAULT_KINDS = {faults.FAULT_KINDS}`):",
        "",
        "| Kind | What happens | How the fleet heals |",
        "|---|---|---|",
        "| `kill` | replica death mid-prefill/mid-decode: copy-free "
        "evacuation, zero leaked pages (asserted) | stranded rollbacks "
        "re-home through the ordinary `_migrate` machinery; work no "
        "surviving replica can serve is reaped as `lost`, loudly |",
        "| `corrupt` | page-table/allocator bookkeeping broken "
        f"({faults.CORRUPT_VARIANTS} variants: stale owner map, aliased "
        "free page, page-table tail) | the per-tick integrity poll "
        "(`PagedServeEngine.check_invariants`) catches it BEFORE "
        "dispatch/decode; the replica is quarantined, its paging books "
        "rebuilt from scratch (`reset_paging`), and readmitted after "
        f"`QUARANTINE_TICKS = {fleet.QUARANTINE_TICKS}` ticks |",
        "| `degrade` | latency spike: FLOPs and bandwidth divided by a "
        f"factor (default {faults.DEGRADE_FACTOR:.0f}x), HBM latency "
        "multiplied — PRICING only, tokens untouched | the router "
        "re-prices through `decode_cell_cost` and organically drains "
        "load; `recover` restores the base spec |",
        "| `recover` | undo a `degrade` | — |",
        "",
        "Recorded-only event kinds: `quarantine`, `readmit`, `lost`, and "
        "`skip` (a scheduled fault with no eligible target — e.g. a kill "
        "beyond `max_kills`, which defaults to fleet size − 1 so a "
        "campaign can never lose the last replica).",
        "",
        "Replica lifecycle states: "
        f"`{fleet.HEALTHY}` / `{fleet.DEGRADED}` (serving, re-priced) / "
        f"`{fleet.QUARANTINED}` (timed, healing) / `{fleet.DEAD}` "
        "(permanent). Only healthy and degraded replicas receive "
        "dispatches; `FleetEngine.check_invariants()` asserts a "
        "quarantined or dead replica holds zero live requests and zero "
        "pages, and that no uid is owned by two replicas.",
        "",
        "Every submitted request ends in exactly one outcome class "
        f"(`fleet.OUTCOME_CLASSES = {fleet.OUTCOME_CLASSES}`): "
        "`completed` (never touched by a fault), `migrated` (finished "
        "on a different replica than it started), `requeued` (finished "
        "on its home after a fault rollback), `lost` (capacity died; "
        "the stream handle is flagged, never left hanging), `cancelled`. "
        "Greedy decoding is schedule-independent, so every finished "
        "request — migrated or not — streams byte-identically to the "
        "fault-free run.",
        "",
        "## Traffic realism: workloads, SLOs, capacity planning",
        "",
        "`serve/workload.py` generates seeded request traces — one "
        "`np.random.default_rng(seed)` stream consumed strictly in tick "
        "order, so a trace is a pure function of its `WorkloadSpec` "
        "(bit-identical fingerprints, and a shorter horizon is a strict "
        "prefix of a longer one). Lengths are "
        "`Gamma(shape, mean/shape)` draws as fractions of `max_len`, "
        "clipped to fit the engine:",
        "",
        "| scenario | prompt mean (frac·shape) | output mean | "
        "turns/arrival | character |",
        "|---|---|---|---|---|",
    ] + [
        (f"| `{s.name}` | {s.prompt_frac:.2f}·max_len "
         f"(shape {s.prompt_shape:g}) | {s.output_frac:.2f}·max_len "
         f"(shape {s.output_shape:g}) | {s.turns_mean:g} "
         f"| {s.description} |")
        for s in (workload.SCENARIOS[k] for k in sorted(workload.SCENARIOS))
    ] + [
        "",
        f"Arrival processes (`ARRIVALS = {workload.ARRIVALS}`): "
        "homogeneous Poisson; **bursty** — a two-state modulated Poisson "
        f"(ON multiplies the rate by {workload.BURST_FACTOR:g}x, "
        f"entered w.p. {workload.BURST_ON_P:g}/tick, left w.p. "
        f"{workload.BURST_OFF_P:g}/tick); **diurnal** — a sinusoidal "
        f"rate with period {workload.DIURNAL_PERIOD} ticks and "
        f"amplitude {workload.DIURNAL_AMPLITUDE:g}. Agent sessions "
        "spread their turns over gaps of up to "
        f"{workload.TURN_GAP_MAX - 1} ticks.",
        "",
        "`serve/slo.py::SLOTracker` hangs off the front end "
        "(`FleetFrontend.slo`): every submission/token/settlement is "
        "stamped in fleet ticks, and `report()` folds them into "
        "deterministic nearest-rank percentiles "
        f"(`PERCENTILES = {slo.PERCENTILES}`) of TTFT (submit → first "
        "token), TPOT (mean inter-token gap) and residence — tick units "
        "throughout; `SLOReport.to_seconds(step_s)` converts with a "
        "profile-priced `decode_cell_cost(...).step_s`. Backpressured "
        "resubmissions pass `arrival_tick=` so TTFT counts from the "
        "ORIGINAL arrival, and `mean_concurrency = Σresidence/makespan "
        "= λ·W` holds exactly (Little's law as an accounting identity).",
        "",
        "`serve/planner.py` inverts the accounting: "
        "`plan_capacity(cfg, arrival_per_tick=λ, ...)` characterizes one "
        "replica — concurrency `C = min(slots, page capacity, "
        "Little's-law inflight bound)`, the same "
        "`required_inflight_bytes / gather_row_bytes` quantum the "
        "router uses — then walks the replica count up to the smallest "
        "`N` whose utilization and predicted p99 TTFT meet the "
        f"`SLOTarget` (defaults: ttft_p99 ≤ "
        f"{planner.SLOTarget().ttft_p99_ticks:g} ticks, ρ ≤ "
        f"{planner.SLOTarget().max_utilization:g}; `MAX_REPLICAS = "
        f"{planner.MAX_REPLICAS}` caps the search, infeasible is "
        "REPORTED, never raised). For `granite-8b` chat traffic at "
        "λ=0.5/tick on the active profile:",
        "",
    ] + (lambda p: [
        "```",
        *p.lines(),
        "```",
    ])(planner.plan_capacity(
        cfg, arrival_per_tick=0.5,
        mean_prompt=workload.SCENARIOS["chat"].mean_prompt(48),
        mean_new=workload.SCENARIOS["chat"].mean_output(48),
        max_slots=3, max_len=48)) + [
        "",
        "`plan_for_trace` reads λ and the length means off a generated "
        "trace's measured stats; `rank_profiles` runs the same plan "
        "across a list of device profiles and sorts by (feasible, "
        "replicas, step_s) — \"how many replicas of WHICH profile\". "
        "The `serve_workload` experiment holds the planner to a "
        "falsifiable claim: a fleet built with exactly the planned "
        "replica count must measure a mean residence within a stated "
        "bound of the predicted `W`, and its measured p99 TTFT must "
        "meet the SLO the plan promised — all deterministic accounting, "
        "no wall-clock verdicts.",
        "",
        "## Try it",
        "",
        "```bash",
        "PYTHONPATH=src python -m repro_torch.launch.serve --arch "
        "granite-8b --smoke \\",
        "    --engine fleet --fleet-profiles tpu_v5e,TeslaV100 \\",
        "    --requests 8 --slots 3 --max-len 48 --device cpu",
        "PYTHONPATH=src python examples/torch_fleet_serve.py --device cpu",
        "PYTHONPATH=src python -m repro_torch.bench run --only serve_fleet "
        "--quick --torch-device cpu",
        "# seeded fault campaign, replay-verified (exits 1 on "
        "divergence)",
        "PYTHONPATH=src python -m repro_torch.launch.serve --arch "
        "granite-8b --smoke \\",
        "    --engine fleet --replicas 2 --requests 12 --faults 1 "
        "--device cpu",
        "# seeded chat workload with SLO report, replay-verified "
        "(exits 1 on divergence)",
        "PYTHONPATH=src python -m repro_torch.launch.serve --arch "
        "granite-8b --smoke \\",
        "    --engine fleet --replicas 2 --workload chat --rate 0.5 \\",
        "    --horizon 24 --workload-replay --device cpu",
        "# capacity planner: replicas-per-profile for a rag workload "
        "(no weights, pure accounting)",
        "PYTHONPATH=src python -m repro_torch.launch.serve --arch "
        "granite-8b --smoke \\",
        "    --engine fleet --fleet-profiles tpu_v5e,TeslaV100 \\",
        "    --workload rag --rate 0.8 --plan",
        "PYTHONPATH=src python -m repro_torch.bench run --only "
        "serve_workload --quick --torch-device cpu",
        "# disaggregated tiers: auto-assigned from the measured "
        "profiles, replay-verified",
        "PYTHONPATH=src python -m repro_torch.launch.serve --arch "
        "granite-8b --smoke \\",
        "    --engine fleet --replicas 2 --fleet-tiers auto \\",
        "    --workload chat --rate 0.5 --horizon 24 --workload-replay "
        "--device cpu",
        "PYTHONPATH=src python -m repro_torch.bench run --only serve_tiers "
        "--quick --torch-device cpu",
        "# mesh-sharded paged replica on 2 CPU ranks",
        "PYTHONPATH=src torchrun --nproc-per-node 2 \\",
        "    examples/torch_sharded_serve.py --quick --device cpu",
        "```",
    ]
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# docs/profiles.md
# ---------------------------------------------------------------------------


def profiles_doc(root: str | None = None) -> str:
    from repro_torch import profile as P

    root = root or P.DEFAULT_ROOT
    shown = str(root).replace(_ROOT, "")
    lines = [
        "# Device profiles: measured vs published",
        "",
        GENERATED_BANNER,
        "One section per committed `repro.profile/v1` artifact under "
        f"`{shown}/`, diffed against the published tables through "
        "`repro_torch/profile/diffing.py` (structural fields exact, "
        "latencies within 2%, sustained bandwidths at or below the "
        "published peak). The committed artifacts are the JAX package's: "
        "`python -m repro_torch.bench profile dissect <device>` writes "
        "under `build/repro_torch/profiles/` and leaves them as they are; "
        "a stale page fails `python -m repro_torch.bench docs --check`.",
        "",
    ]
    names = ([] if not os.path.isdir(root) else
             sorted(n for n in os.listdir(root) if n.endswith(".json")))
    for name in names:
        prof = P.load_profile(os.path.join(root, name))
        pc = prof.provenance_counts()
        lines += [
            f"## {prof.device} ({prof.kind}/{prof.generation})",
            "",
            f"`{shown}/{name}` — {len(prof.caches)} structures, "
            f"{len(prof.latency)} latency classes; "
            f"**{pc['measured']} measured / {pc['published']} published** "
            f"fields (engine `{prof.engine}`/`{prof.engine_version}`, "
            f"registry `{prof.registry_hash}`).",
            "",
        ]
        if prof.timings:
            total = prof.timings.get("total", 0.0)
            lines += [
                f"Dissection wall time: **{total:.3f} s** total.",
                "",
                "| Stage | Seconds |",
                "|---|---:|",
            ]
            for stage in sorted(prof.timings,
                                key=lambda s: -prof.timings[s]):
                if stage == "total":
                    continue
                lines.append(f"| {stage} | {prof.timings[stage]:.4f} |")
            lines.append("")
        stale = prof.is_stale()
        if stale:
            lines += ["**STALE:** " + "; ".join(stale), ""]
            continue
        if prof.kind == "tpu":
            lines += [
                "Published spec end to end (no on-hardware dissection on "
                "this host); consumers price against these fields:",
                "",
                "| Field | Value | Provenance |",
                "|---|---:|---|",
            ]
            for k in sorted(prof.spec):
                lines.append(
                    f"| {k} | {prof.spec[k]:.6g} "
                    f"| {prof.spec_provenance.get(k, '?')} |")
            lines.append("")
            continue
        rows = P.diff_profiles(prof, P.published_profile(prof.device))
        bad = [r for r in rows if not r.ok]
        lines += [
            f"**{len(rows) - len(bad)} ok · {len(bad)} mismatched** "
            f"({len(rows)} diffed fields)",
            "",
            "| Field | Measured | Published | Rule | Verdict | Note |",
            "|---|---|---|---|---|---|",
        ]
        for r in rows:
            lines.append(
                f"| {_md_escape(r.field)} | {_md_escape(r.measured)} "
                f"| {_md_escape(r.published)} | {r.rule} "
                f"| {'ok' if r.ok else 'MISMATCH'} "
                f"| {_md_escape(r.note)} |")
        lines.append("")
    if not names:
        lines += ["(no committed profile artifacts)", ""]
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# docs/cli.md — rendered from the argparse definitions themselves
# ---------------------------------------------------------------------------

#: defaults that depend on the host (core counts) — documented by their
#: formula, not the value this machine happened to compute
_HOST_DEPENDENT_DEFAULTS = {
    ("python -m repro_torch.bench run", "--jobs"): "min(cores, 8)",
}


def _flag_rows(prog: str, parser: argparse.ArgumentParser) -> list[str]:
    rows = []
    for a in parser._actions:
        if isinstance(a, (argparse._HelpAction,
                          argparse._SubParsersAction)):
            continue
        if a.option_strings:
            name = ", ".join(a.option_strings)
            if a.metavar:
                name += f" {a.metavar}"
            elif a.choices:
                name += " {" + ",".join(str(c) for c in a.choices) + "}"
            elif not isinstance(a, (argparse._StoreTrueAction,
                                    argparse._StoreFalseAction)):
                name += f" {a.dest.upper()}"
        else:
            name = a.metavar or a.dest
            if a.choices:
                name += " {" + ",".join(str(c) for c in a.choices) + "}"
        key = (prog, a.option_strings[0] if a.option_strings else a.dest)
        if key in _HOST_DEPENDENT_DEFAULTS:
            default = _HOST_DEPENDENT_DEFAULTS[key]
        elif a.default in (None, argparse.SUPPRESS):
            default = "—"
        elif a.default is False:
            default = "off"
        else:
            default = f"`{_md_escape(a.default)}`"
        rows.append(f"| `{_md_escape(name)}` | {default} "
                    f"| {_md_escape(a.help or '')} |")
    return rows


def _render_parser(title: str, prog: str,
                   parser: argparse.ArgumentParser) -> list[str]:
    lines = [f"## {title}", ""]
    desc = (parser.description or "").strip()
    if desc:
        first = desc.splitlines()[0].strip()
        if first:
            lines += [first, ""]
    subactions = [a for a in parser._actions
                  if isinstance(a, argparse._SubParsersAction)]
    top = _flag_rows(prog, parser)
    if top:
        lines += [f"`{prog}`", "",
                  "| Flag | Default | Description |", "|---|---|---|"]
        lines += top + [""]
    for sub in subactions:
        for cmd, sp in sub.choices.items():
            sub_prog = f"{prog} {cmd}"
            lines += [f"### `{sub_prog}`", ""]
            help_text = next(
                (c.help for c in sub._choices_actions if c.dest == cmd), "")
            if help_text:
                lines += [_md_escape(help_text), ""]
            rows = _flag_rows(sub_prog, sp)
            if rows:
                lines += ["| Flag | Default | Description |",
                          "|---|---|---|"] + rows
            lines.append("")
    return lines


def cli_doc() -> str:
    # imports are local: registry discovery must not pay for the launchers
    from repro_torch.bench import __main__ as bench_main
    from repro_torch.launch import dryrun, perf, serve, train

    lines = [
        "# CLI reference",
        "",
        GENERATED_BANNER,
        "Every table below is walked out of the argparse definition the "
        "command actually parses with (`build_parser()` on each module), "
        "so flags are documented by their own `help=` strings and can "
        "never drift from the code.",
        "",
    ]
    lines += _render_parser("Dissection harness (`repro_torch.bench`)",
                            "python -m repro_torch.bench",
                            bench_main.build_parser())
    lines += _render_parser("Serving launcher",
                            "python -m repro_torch.launch.serve",
                            serve.build_parser())
    lines += _render_parser("Perf hillclimbing driver",
                            "python -m repro_torch.launch.perf",
                            perf.build_parser())
    lines += _render_parser("Training launcher",
                            "python -m repro_torch.launch.train",
                            train.build_parser())
    lines += _render_parser("Compile dry-run driver",
                            "python -m repro_torch.launch.dryrun",
                            dryrun.build_parser())
    return "\n".join(lines) + "\n"
