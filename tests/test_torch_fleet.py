"""The port's fleet layer against the JAX package's on the CPU.

Both fleets serve the same schedules (the micro f32 config of the
reference's fleet tests, weights carried across by ``params_from_jax``,
prompts made with numpy from a seed). The fleet's schedule does not
depend on the tokens, so the two must agree bit for bit: the merged
decision log, ``classify()``, ``stats()``, ``margin_violations()`` and
the greedy tokens per uid. The schedules: N=1 (also against the port's
own ``PagedServeEngine``), a mixed GTX980/TeslaV100/tpu_v5e fleet, a
stranded preemption that migrates, the router's margin and inflight
rules, cancellation everywhere and saturation backpressure through the
front end, tiered fleets, scripted and seeded fault campaigns, and
workload replays. The pure modules (tiers, slo, workload, planner) are
held to the reference's outputs case by case.
"""

import dataclasses
import itertools
import types

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.devices import TpuSpec as JTpuSpec
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JModelConfig
from repro.profile import published_profile as jpublished
from repro.serve import faults as jfaults
from repro.serve import fleet as jfleet
from repro.serve import frontend as jfrontend
from repro.serve import planner as jplanner
from repro.serve import slo as jslo
from repro.serve import tiers as jtiers
from repro.serve import workload as jworkload
from repro.serve.engine import Request as JRequest
from repro_torch.core.devices import TpuSpec
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.profile import published_profile
from repro_torch.serve import faults, fleet, frontend, planner, slo, tiers
from repro_torch.serve import workload
from repro_torch.serve.engine import PagedServeEngine, Request

MICRO = dict(name="micro", family="dense", num_layers=2, d_model=32,
             d_ff=64, vocab_size=64, num_heads=2, num_kv_heads=2,
             dtype="float32", param_dtype="float32")
WORK = [(8, 6), (12, 4), (5, 9), (16, 3), (7, 7), (3, 5)]
MAX_LEN = 32
GPUS3 = ("GTX980", "TeslaV100", "tpu_v5e")

#: one namespace per package, so a schedule is written once
JAX = types.SimpleNamespace(
    FleetEngine=jfleet.FleetEngine, FleetFrontend=jfrontend.FleetFrontend,
    Backpressure=jfrontend.Backpressure, Request=JRequest,
    TpuSpec=JTpuSpec, published=jpublished, faults=jfaults,
    workload=jworkload, planner=jplanner)
PORT = types.SimpleNamespace(
    FleetEngine=fleet.FleetEngine, FleetFrontend=frontend.FleetFrontend,
    Backpressure=frontend.Backpressure, Request=Request,
    TpuSpec=TpuSpec, published=published_profile, faults=faults,
    workload=workload, planner=planner)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models here are tiny: one intra-op thread for torch keeps a
    parallel test run from oversubscribing the host's cores (2.5x faster
    under ``-n 4``). Results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sides():
    """(namespace, cfg, params) for the reference and for the port."""
    jcfg = JModelConfig(**MICRO)
    jparams = JT.init_params(jcfg, jax.random.key(0))
    cfg = ModelConfig(**MICRO)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    return (JAX, jcfg, jparams), (PORT, cfg, params)


@pytest.fixture(autouse=True)
def no_flash_launch():
    """The fleet path takes the masked plain branch: no kernel launches."""
    before = fa.launches
    yield
    assert fa.launches == before


def _requests(s, cfg, work=WORK, seed=0):
    rng = np.random.default_rng(seed)
    return [s.Request(uid, rng.integers(cfg.vocab_size, size=plen)
                      .astype(np.int32), n_new)
            for uid, (plen, n_new) in enumerate(work)]


def _books(f) -> dict:
    """Everything a fleet run decides, in plain Python values."""
    f.check_invariants()
    return {"log": f.decision_log(), "classes": f.classify(),
            "stats": f.stats(), "ticks": f.ticks,
            "tokens": {r.uid: list(r.generated) for r in f.finished()},
            "violations": [d.key() for d in f.margin_violations()]}


def _both(sides, run):
    """``run(ns, cfg, params)`` on the reference and on the port."""
    (j, jcfg, jparams), (p, cfg, params) = sides
    return run(j, jcfg, jparams), run(p, cfg, params)


# ---------------------------------------------------------------------------
# fleet schedules
# ---------------------------------------------------------------------------


def _sched_n1(s, cfg, params):
    f = s.FleetEngine(cfg, params, max_slots=2, max_len=MAX_LEN, replicas=1)
    for r in _requests(s, cfg):
        f.submit(r)
    f.run_to_completion()
    return _books(f)


def _sched_mixed(s, cfg, params):
    f = s.FleetEngine(cfg, params, max_slots=2, max_len=MAX_LEN,
                      profiles=[s.published(d) for d in GPUS3])
    for r in _requests(s, cfg):
        f.submit(r)
    f.run_to_completion()
    return _books(f)


def _sched_migration(s, cfg, params):
    """Work placed on replica 0 behind a page-dry pool strands a
    preemption rollback, which migrates to replica 1."""
    f = s.FleetEngine(cfg, params, max_slots=3, max_len=16, replicas=2,
                      page_len=2, num_pages=[8, 12])
    for r in _requests(s, cfg, work=[(2, 8)] * 3, seed=1):
        f.replicas[0].engine.submit(r)
    f.run_to_completion()
    return _books(f)


def _sched_margin(s, cfg, params):
    fast = s.TpuSpec(name="fast")
    slow = s.TpuSpec(name="slow", peak_bf16_flops=fast.peak_bf16_flops / 20,
                     hbm_bytes_per_s=fast.hbm_bytes_per_s / 20)
    f = s.FleetEngine(cfg, params, max_slots=2, max_len=MAX_LEN,
                      profiles=[slow, fast])
    for r in _requests(s, cfg):
        f.submit(r)
    f.run_to_completion()
    return _books(f)


def _sched_inflight(s, cfg, params):
    tiny = s.TpuSpec(name="tiny", hbm_bytes_per_s=1e6, hbm_latency_s=1e-6)
    f = s.FleetEngine(cfg, params, max_slots=2, max_len=MAX_LEN,
                      profiles=[tiny, tiny], page_len=4, num_pages=[40, 10])
    for r in _requests(s, cfg, work=[(4, 4), (4, 4)]):
        f.submit(r)
    f.run_to_completion()
    return _books(f)


FLEET_SCHEDULES = {"n1": _sched_n1, "mixed": _sched_mixed,
                   "migration": _sched_migration, "margin": _sched_margin,
                   "inflight": _sched_inflight}


@pytest.mark.parametrize("name", list(FLEET_SCHEDULES))
def test_fleet_matches_reference(sides, name):
    want, got = _both(sides, FLEET_SCHEDULES[name])
    assert got == want
    assert got["stats"]["pages_leaked"] == 0
    assert not got["violations"]
    if name == "migration":
        assert got["stats"]["migrations"] >= 1
        assert got["stats"]["preemptions"] >= 1
    if name == "mixed":
        used = [p["finished"] for p in got["stats"]["per_replica"]]
        assert sum(1 for u in used if u) >= 2


def test_n1_fleet_is_the_ports_paged_engine(sides):
    """The reference's N=1 contract inside the port: the same tokens on
    the same tick schedule as one ``PagedServeEngine``."""
    _, (p, cfg, params) = sides
    eng = PagedServeEngine(cfg, params, max_slots=2, max_len=MAX_LEN)
    for r in _requests(p, cfg):
        eng.submit(r)
    want = {r.uid: r.generated for r in eng.run_to_completion()}
    got = _sched_n1(p, cfg, params)
    assert got["tokens"] == want
    assert got["ticks"] == eng.steps


def test_mesh_is_not_ported(sides):
    """A serving mesh is ported (tests/test_torch_sharded*.py): what is
    not a mesh is refused by name, and rules without a mesh change
    nothing, as in the reference."""
    _, (p, cfg, params) = sides
    with pytest.raises(TypeError, match="axis names and sizes"):
        p.FleetEngine(cfg, params, max_slots=2, max_len=MAX_LEN,
                      mesh=object())
    f = p.FleetEngine(cfg, params, max_slots=2, max_len=MAX_LEN,
                      shard_rules={"cache_pages": "data"})
    assert [(r.mesh, r.engine.shards) for r in f.replicas] == [(None, 1)]


def test_replicas_share_one_parameter_object(sides):
    _, (p, cfg, params) = sides
    f = p.FleetEngine(cfg, params, max_slots=2, max_len=MAX_LEN,
                      profiles=list(GPUS3))
    assert all(r.engine.params is params for r in f.replicas)


@pytest.mark.parametrize("entry", ["tpu_v5e", "TeslaV100", "GTX980",
                                   "GTX560Ti", None])
def test_resolve_fleet_profile_matches_reference(entry):
    got = fleet.resolve_fleet_profile(entry)
    want = jfleet.resolve_fleet_profile(entry)
    assert (None if got is None else dataclasses.asdict(got)) == \
        (None if want is None else dataclasses.asdict(want))


def test_unservable_request_rejected_as_reference(sides):
    def run(s, cfg, params):
        f = s.FleetEngine(cfg, params, max_slots=1, max_len=16, replicas=2,
                          page_len=4, num_pages=3)
        out = []
        for req in (s.Request(0, np.zeros(8, np.int32), 12),
                    s.Request(1, np.zeros(8, np.int32), 4)):
            with pytest.raises(ValueError) as e:
                f.submit(req)
            out.append(str(e.value))
        return out, f.rejected

    want, got = _both(sides, run)
    assert got == want


# ---------------------------------------------------------------------------
# the front end and SLO accounting
# ---------------------------------------------------------------------------


def _front_run(front, f, handles):
    return {"streams": {h.uid: list(h.tokens) for h in handles},
            "states": {h.uid: (h.done, h.cancelled, h.lost)
                       for h in handles},
            "slo": repr(front.slo.report().key()),   # NaN-safe
            "slo_lines": front.slo.report().lines(), **_books(f)}


def _front_stream(s, cfg, params):
    """Callbacks on a mixed fleet: every (uid, token, tick) in order."""
    f = s.FleetEngine(cfg, params, max_slots=2, max_len=MAX_LEN,
                      profiles=["TeslaV100", "tpu_v5e"])
    front = s.FleetFrontend(f, max_pending=len(WORK))
    calls, ends = [], []
    for r in _requests(s, cfg):
        front.submit(r.prompt, r.max_new_tokens, uid=r.uid,
                     on_token=lambda u, t: calls.append((u, t, f.ticks)),
                     on_finish=lambda h: ends.append((h.uid, f.ticks)))
    handles = front.run()
    return {"calls": calls, "ends": ends, **_front_run(front, f, handles)}


def _front_cancel(s, cfg, params):
    """One live and one queued request cancelled; the rest stream on."""
    f = s.FleetEngine(cfg, params, max_slots=1, max_len=MAX_LEN, replicas=1)
    front = s.FleetFrontend(f, max_pending=8)
    ends = []
    for r in _requests(s, cfg, work=[(4, 8), (4, 8), (4, 8)]):
        front.submit(r.prompt, r.max_new_tokens, uid=r.uid,
                     on_finish=lambda h: ends.append(
                         (h.uid, h.cancelled, f.ticks)))
    front.tick()
    acks = [front.cancel(0), front.cancel(2), front.cancel(2)]
    handles = front.run()
    return {"acks": acks, "ends": ends, **_front_run(front, f, handles)}


def _front_backpressure(s, cfg, params):
    f = s.FleetEngine(cfg, params, max_slots=1, max_len=MAX_LEN, replicas=1,
                      page_len=4)
    front = s.FleetFrontend(f, max_pending=2)
    calls, events = [], []
    work = _requests(s, cfg, work=[(4, 6)] * 4)

    def sub(r):
        front.submit(r.prompt, r.max_new_tokens, uid=r.uid,
                     on_token=lambda u, t: calls.append((u, t, f.ticks)))

    sub(work[0])
    front.tick()
    sub(work[1])
    sub(work[2])
    with pytest.raises(s.Backpressure) as e:
        sub(work[3])
    events.append(str(e.value))
    while front.backpressure:
        events.append(("tick", f.ticks, f.saturated))
        front.tick()
    sub(work[3])
    handles = front.run()
    return {"calls": calls, "events": events,
            **_front_run(front, f, handles)}


FRONT_SCHEDULES = {"stream": _front_stream, "cancel": _front_cancel,
                   "backpressure": _front_backpressure}


@pytest.mark.parametrize("name", list(FRONT_SCHEDULES))
def test_frontend_matches_reference(sides, name):
    want, got = _both(sides, FRONT_SCHEDULES[name])
    assert got == want
    assert got["stats"]["pages_leaked"] == 0
    if name == "cancel":
        assert got["acks"] == [True, True, False]
        assert got["states"][1] == (True, False, False)


@settings(max_examples=60, deadline=None)
@given(vals=st.lists(st.one_of(st.integers(-1000, 1000),
                               st.floats(-1e6, 1e6, allow_nan=False)),
                     max_size=40),
       q=st.floats(-5, 105, allow_nan=False))
def test_percentile_matches_reference(vals, q):
    try:
        want = jslo.percentile(vals, q)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:20]):
            slo.percentile(vals, q)
        return
    assert slo.percentile(vals, q) == want


def test_slo_tracker_misuse_matches_reference():
    def run(mod):
        t = mod.SLOTracker()
        out = []
        for call in (lambda: t.on_token(7, 0), lambda: t.on_finish(7, 0, "x"),
                     lambda: (t.on_submit(1, 0), t.on_submit(1, 1)),
                     lambda: t.on_finish(1, 2, "meteor")):
            try:
                call()
                out.append(None)
            except (KeyError, ValueError) as e:
                out.append((type(e).__name__, str(e)))
        return out, repr(t.report().key())

    assert run(slo) == run(jslo)


# ---------------------------------------------------------------------------
# tiers
# ---------------------------------------------------------------------------


TIER_TEXTS = [("prefill:0,1/decode:2,3", 4), ("decode:0,1/prefill:1", 2),
              ("prefill:0/decode:1", 2), ("prefill:0,2/decode:1", 3),
              ("prefill:0", 2), ("prefill:0/decode:", 2),
              ("prefill:0/decode:x", 2), ("prefill:0/prefill:1", 2),
              ("prefill:0/decode:5", 2), ("warmup:0/decode:1", 2),
              ("prefill:0/decode:0", 2), (" Prefill:1 / Decode:0 ", 2)]


def _outcome(fn):
    try:
        return ("ok", fn())
    except (ValueError, TypeError) as e:
        return (type(e).__name__, str(e))


def _plan_tuple(plan):
    return (plan.prefill, plan.decode, plan.tiered, plan.describe())


@pytest.mark.parametrize("text,n", TIER_TEXTS)
def test_parse_tiers_matches_reference(text, n):
    got = _outcome(lambda: _plan_tuple(tiers.parse_tiers(text, n)))
    want = _outcome(lambda: _plan_tuple(jtiers.parse_tiers(text, n)))
    assert got == want


def test_auto_and_resolve_tiers_match_reference():
    names = ["tpu_v5e", "TeslaV100", "GTX980", "GTX560Ti", "GTX780"]
    for k in (1, 2, 3, 4):
        for combo in itertools.permutations(names, k):
            specs = [published_profile(d).serving_spec() for d in combo]
            jspecs = [jpublished(d).serving_spec() for d in combo]
            assert _plan_tuple(tiers.auto_tiers(specs)) == \
                _plan_tuple(jtiers.auto_tiers(jspecs)), combo
            for t in (None, "none", "symmetric", "auto", "prefill:0/decode:1",
                      3.14):
                got = _outcome(lambda: _plan_tuple(
                    tiers.resolve_tiers(t, k, specs)))
                want = _outcome(lambda: _plan_tuple(
                    jtiers.resolve_tiers(t, k, jspecs)))
                assert got == want, (combo, t)


def test_handoff_pricing_matches_reference(sides):
    (_, jcfg, _), (_, cfg, _) = sides
    names = ["tpu_v5e", "TeslaV100", "GTX980", "GTX560Ti"]
    for n_pages, page_len in ((1, 4), (3, 8), (17, 128)):
        assert tiers.handoff_bytes(cfg, n_pages, page_len) == \
            jtiers.handoff_bytes(jcfg, n_pages, page_len)
    for a, b in itertools.product(names, repeat=2):
        sa, sb = (published_profile(a).serving_spec(),
                  published_profile(b).serving_spec())
        ja, jb = jpublished(a).serving_spec(), jpublished(b).serving_spec()
        for nb in (0, 4096, 1 << 20, 3 << 30):
            assert tiers.handoff_seconds(nb, sa, sb) == \
                jtiers.handoff_seconds(nb, ja, jb)
    for h, step in itertools.product((0.0, 1e-7, 3e-5, 2.5e-3),
                                     (0.0, 1e-9, 4e-5, 1e-3)):
        assert tiers.handoff_ticks(h, step) == jtiers.handoff_ticks(h, step)


def _tiered(plan, profiles=None, replicas=2, max_slots=3):
    def run(s, cfg, params):
        f = s.FleetEngine(cfg, params, max_slots=max_slots, max_len=MAX_LEN,
                          replicas=None if profiles else replicas,
                          profiles=profiles, page_len=4, tiers=plan)
        for r in _requests(s, cfg):
            f.submit(r)
        f.run_to_completion()
        return _books(f)
    return run


TIERED = {"auto": ("auto", ["TeslaV100", "tpu_v5e"], 2),
          "p0_d1": ("prefill:0/decode:1", None, 2),
          "p01_d2": ("prefill:0,1/decode:2", None, 3),
          "auto3": ("auto", list(GPUS3), 3)}


@pytest.mark.parametrize("name", list(TIERED))
def test_tiered_fleet_matches_reference(sides, name):
    plan, profiles, n = TIERED[name]
    want, got = _both(sides, _tiered(plan, profiles, n))
    assert got == want
    assert got["stats"]["tiered"] and got["stats"]["handoffs"] > 0
    assert {k[3] for k in got["log"] if k[3] in ("admit", "handoff")} == \
        {"admit", "handoff"}
    assert not got["violations"] and got["stats"]["pages_leaked"] == 0


@pytest.mark.parametrize("name", ["auto", "p0_d1", "p01_d2"])
def test_tiered_tokens_equal_ports_symmetric_fleet(sides, name):
    """The tiered fleet is held to the port's own symmetric fleet (the
    reference's oracle test for it is intermittent), run twice."""
    _, (p, cfg, params) = sides
    plan, profiles, n = TIERED[name]
    sym = _tiered(None, profiles, n)(p, cfg, params)
    a = _tiered(plan, profiles, n)(p, cfg, params)
    b = _tiered(plan, profiles, n)(p, cfg, params)
    assert a == b
    assert a["tokens"] == sym["tokens"]
    assert a["stats"]["handoffs"] > 0


def _burst(plan):
    """The reference property test's full admission burst on one plan,
    with the single-residency check every tick."""
    def run(s, cfg, params):
        f = s.FleetEngine(cfg, params, replicas=3, max_slots=3, max_len=32,
                          page_len=4, prefill_chunk=8, tiers=plan)
        rng = np.random.default_rng(7)
        for uid in range(8):
            f.submit(s.Request(uid, rng.integers(1, cfg.vocab_size,
                                                 size=2 + uid % 7)
                               .astype(np.int32), 1 + uid % 6))
        while f.live() or f.pending:
            assert f.ticks < 2000
            f.step()
            for uid in range(8):
                assert sum(1 for r in f.replicas
                           if r.engine.alloc.pages.get(uid)) <= 1
            f.check_invariants()
        return _books(f)
    return run


@pytest.mark.parametrize("plan", ["prefill:0,2/decode:1",
                                  "prefill:0/decode:1,2",
                                  "prefill:0,1,2/decode:2"])
def test_burst_outcomes_match_reference_whatever_they_are(sides, plan):
    """Whatever class each uid ends in on the reference (on plan
    ``prefill:0,2/decode:1`` one ends ``migrated``), the port ends it
    there too, with the same log and tokens."""
    want, got = _both(sides, _burst(plan))
    assert got == want
    assert got["stats"]["pages_leaked"] == 0


# ---------------------------------------------------------------------------
# faults
# ---------------------------------------------------------------------------


N_REQ = 10


def _campaign(injector_args, replicas=2, front=False):
    """A campaign on the reference tests' fault fleet: 2 replicas, 4
    slots, max_len 48, page_len 8, prefill_chunk 16, ten seeded
    requests. ``injector_args`` builds the injector on each side."""
    def run(s, cfg, params):
        f = s.FleetEngine(cfg, params, replicas=replicas, max_slots=4,
                          max_len=48, page_len=8, prefill_chunk=16)
        rng = np.random.default_rng(7)
        work = [(rng.integers(1, cfg.vocab_size,
                              size=int(rng.integers(4, 12))).astype(np.int32),
                 int(rng.integers(4, 10))) for _ in range(N_REQ)]
        inj = injector_args(s.faults)
        rep = s.faults.run_campaign(f, work, inj)
        return {"outcomes": rep.outcomes, "streams": rep.streams,
                "log": rep.log, "events": rep.event_counts,
                "stats": rep.stats, "counts": rep.outcome_counts(),
                "states": [r.state for r in f.replicas],
                "injector": None if inj is None else inj.stats(),
                **{k: v for k, v in _books(f).items() if k != "stats"}}
    return run


def _script(*faults_args, **kw):
    return lambda m: m.FaultInjector(
        tuple(m.Fault(*a, **k) for a, k in faults_args), **kw)


SCRIPTED = {
    "fault_free": lambda m: None,
    "kill_mid_prefill": _script(((1, "kill"), {})),
    "kill_mid_decode": _script(((6, "kill"), {})),
    "corrupt_v0": _script(((5, "corrupt"), {"variant": 0})),
    "corrupt_v1": _script(((5, "corrupt"), {"variant": 1})),
    "corrupt_v2": _script(((5, "corrupt"), {"variant": 2})),
    "degrade_recover": _script(((0, "degrade"),
                                {"replica": 0, "factor": 16.0}),
                               ((6, "recover"), {})),
    "mixed": _script(((2, "degrade"), {"factor": 4.0}),
                     ((5, "corrupt"), {}), ((8, "kill"), {}),
                     ((12, "recover"), {})),
    "skip_and_spare": _script(((0, "corrupt"), {}), ((3, "kill"), {}),
                              ((6, "kill"), {}), ((9, "kill"), {})),
}


@pytest.mark.parametrize("name", list(SCRIPTED))
def test_scripted_campaign_matches_reference(sides, name):
    want, got = _both(sides, _campaign(SCRIPTED[name]))
    assert got == want
    assert got["stats"]["pages_leaked"] == 0
    assert set(got["outcomes"].values()) <= set(fleet.OUTCOME_CLASSES)
    assert sorted(got["outcomes"]) == list(range(N_REQ))
    if name.startswith("corrupt"):
        assert got["events"].get("quarantine") == 1
        assert got["events"].get("readmit") == 1


def test_killing_the_last_replica_loses_as_reference(sides):
    run = _campaign(lambda m: m.FaultInjector(
        (m.Fault(4, "kill", replica=0),), max_kills=1), replicas=1)
    want, got = _both(sides, run)
    assert got == want
    assert "lost" in got["outcomes"].values()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_campaign_matches_reference_and_replays(sides, seed):
    run = _campaign(lambda m: m.FaultInjector.campaign(seed, rate=0.15,
                                                       horizon=60))
    want, got = _both(sides, run)
    assert got == want
    assert got["events"], f"seed {seed} fired no faults"
    _, (p, cfg, params) = sides
    assert run(p, cfg, params) == got


def test_fault_api_errors_match_reference():
    for mod in (faults, jfaults):
        assert set(mod.FAULT_KINDS) == {"kill", "corrupt", "degrade",
                                        "recover"}
    got = [_outcome(lambda: faults.Fault(0, "meteor")),
           _outcome(lambda: faults.FaultInjector.campaign(
               0, kinds=("kill", "meteor")))]
    want = [_outcome(lambda: jfaults.Fault(0, "meteor")),
            _outcome(lambda: jfaults.FaultInjector.campaign(
                0, kinds=("kill", "meteor")))]
    assert got == want and got[0][0] == "ValueError"


# ---------------------------------------------------------------------------
# workload and planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scenario", sorted(jworkload.SCENARIOS))
@pytest.mark.parametrize("arrival", jworkload.ARRIVALS)
def test_trace_fingerprint_matches_reference(scenario, arrival):
    kw = dict(scenario=scenario, arrival=arrival, rate=0.8, horizon=32,
              seed=3, max_len=48)
    got = workload.generate_trace(workload.WorkloadSpec(**kw))
    want = jworkload.generate_trace(jworkload.WorkloadSpec(**kw))
    assert got.fingerprint() == want.fingerprint()
    assert got.stats() == want.stats()
    assert sorted(workload.SCENARIOS) == sorted(jworkload.SCENARIOS)
    assert workload.ARRIVALS == jworkload.ARRIVALS


def test_workload_spec_validation_matches_reference():
    bad = [dict(scenario="meteor"), dict(arrival="meteor"), dict(rate=0),
           dict(horizon=0), dict(max_len=1), dict(rate=-1.0)]
    for kw in bad:
        assert _outcome(lambda: workload.WorkloadSpec(**kw)) == \
            _outcome(lambda: jworkload.WorkloadSpec(**kw))


def _replay(scenario, arrival, profiles, tiers_=None):
    def run(s, cfg, params):
        spec = s.workload.WorkloadSpec(scenario=scenario, arrival=arrival,
                                       rate=0.7, horizon=24, seed=2,
                                       max_len=MAX_LEN,
                                       vocab_size=cfg.vocab_size)
        trace = s.workload.generate_trace(spec)
        f = s.FleetEngine(cfg, params, max_slots=2, max_len=MAX_LEN,
                          profiles=profiles, tiers=tiers_)
        front = s.FleetFrontend(f)
        s.workload.replay_trace(front, trace)
        return {"fingerprint": trace.fingerprint(),
                **_front_run(front, f, front.handles.values())}
    return run


REPLAYS = {"chat_poisson": ("chat", "poisson", ["TeslaV100", "tpu_v5e"]),
           "agent_bursty": ("agent", "bursty", ["tpu_v5e", "GTX980"]),
           "rag_diurnal_tiered": ("rag", "diurnal", ["TeslaV100", "tpu_v5e"],
                                  "auto")}


@pytest.mark.parametrize("name", list(REPLAYS))
def test_replay_trace_matches_reference(sides, name):
    want, got = _both(sides, _replay(*REPLAYS[name]))
    assert got == want
    assert got["stats"]["pages_leaked"] == 0


def _asdict(x):
    return dataclasses.asdict(x) | {"lines": x.lines()}


def test_planner_matches_reference(sides):
    """``plan_capacity``, ``characterize_replica``, ``rank_profiles`` and
    ``plan_tiers`` field for field, on the micro and smoke granite-8b
    configs, across profiles, loads and SLOs."""
    from repro import configs as jconfigs
    from repro_torch import configs
    (_, jmicro, _), (_, micro, _) = sides
    cfgs = [(jmicro, micro), (jconfigs.get_smoke_config("granite-8b"),
                              configs.get_smoke_config("granite-8b"))]
    names = ["tpu_v5e", "TeslaV100", "GTX980"]
    for (jcfg, cfg), lam, ttft in itertools.product(
            cfgs, (0.05, 0.6, 3.0), (4.0, 32.0)):
        kw = dict(arrival_per_tick=lam, mean_prompt=14.9, mean_new=28.0,
                  max_slots=4, max_len=96)
        got = planner.rank_profiles(cfg, names, **kw,
                                    slo=planner.SLOTarget(ttft_p99_ticks=ttft))
        want = jplanner.rank_profiles(
            jcfg, names, **kw, slo=jplanner.SLOTarget(ttft_p99_ticks=ttft))
        assert [_asdict(p) for p in got] == [_asdict(p) for p in want]
        got = planner.plan_tiers(cfg, names, **kw, page_len=8,
                                 slo=planner.SLOTarget(ttft_p99_ticks=ttft))
        want = jplanner.plan_tiers(
            jcfg, names, **kw, page_len=8,
            slo=jplanner.SLOTarget(ttft_p99_ticks=ttft))
        assert _asdict(got) == _asdict(want)
    for name in names:
        kw = dict(max_slots=3, max_len=48, mean_prompt=9.0, mean_new=5.0,
                  num_pages=20)
        assert dataclasses.asdict(planner.characterize_replica(
            micro, spec=fleet.resolve_fleet_profile(name), **kw)) == \
            dataclasses.asdict(jplanner.characterize_replica(
                jmicro, spec=jfleet.resolve_fleet_profile(name), **kw))
    assert _outcome(lambda: planner.plan_capacity(
        micro, arrival_per_tick=0, mean_prompt=1, mean_new=1, max_slots=1,
        max_len=8)) == _outcome(lambda: jplanner.plan_capacity(
            jmicro, arrival_per_tick=0, mean_prompt=1, mean_new=1,
            max_slots=1, max_len=8))


@pytest.mark.parametrize("scenario", ["chat", "rag", "batch"])
def test_plan_for_trace_matches_reference(sides, scenario):
    (_, jcfg, _), (_, cfg, _) = sides
    kw = dict(scenario=scenario, rate=0.9, horizon=32, seed=1, max_len=48)
    trace = workload.generate_trace(workload.WorkloadSpec(**kw))
    jtrace = jworkload.generate_trace(jworkload.WorkloadSpec(**kw))
    for name in ("tpu_v5e", "TeslaV100"):
        got = planner.plan_for_trace(cfg, trace,
                                     spec=fleet.resolve_fleet_profile(name),
                                     max_slots=3, max_len=48)
        want = jplanner.plan_for_trace(
            jcfg, jtrace, spec=jfleet.resolve_fleet_profile(name),
            max_slots=3, max_len=48)
        assert _asdict(got) == _asdict(want)
