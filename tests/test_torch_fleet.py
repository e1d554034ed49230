"""The port's multi-engine serving fleet, re-pointed from the reference's
``tests/test_fleet_serving.py`` and held against the reference's fleet on
the same weights (CPU).

Pinned here:

1. a 2-engine fleet gives one engine's greedy tokens exactly (routing
   changes where a token is computed, never what it is), and one engine
   gives the reference's (margin-gated);
2. shared-prefix traffic affinity-routes to the engine holding the prefix
   and hits its prefix cache; cold traffic balances by load;
3. ``retire_engine`` migrates every live request to a peer (detached
   transfer file, or resubmit) without the caller's stream noticing;
4. chaos: ``hard_abandon`` of one engine mid-burst migrates its requests
   onto survivors, the burst finishes identical to a calm single engine
   over 5 seeds, the counters reconcile and the survivor's step keys do
   not move;
5. the autoscaler's dwell/clear discipline and its bounds;
6. the aggregated exposition: one TYPE per name, ``engine`` labels,
   ``reason`` labels, every line parses;
7. aggregated health/SLO and ``FleetSupervisor`` escalation;
8. across the packages: the same traffic under a fake clock gives the same
   routing decisions (engine and reason) in the reference's fleet and the
   port's.

Tolerances: tokens exact within the port; against the reference, greedy
equality is margin-gated (``torch_parity``); routing decisions exact.
"""
import io
import json
import re
import threading
import time

import numpy as np
import pytest

from torch_parity import (SMALL, FakeClock, RefEngines, assert_greedy_equal,
                          build_pair)

from paddle_tpu_torch import ServingEngine
from paddle_tpu_torch.core.errors import (InvalidArgumentError,
                                          PreconditionNotMetError)
from paddle_tpu_torch.inference.generation import DuplicateRequestError
from paddle_tpu_torch.serving import (FleetSupervisor, RequestState,
                                      ServingFleet)
from paddle_tpu_torch.serving import log as slog


@pytest.fixture(scope="module")
def pair():
    return build_pair(**SMALL)


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


_CFG = dict(max_len=64, slots=2, buckets=[64], cache_layout="paged",
            block_size=8, prefill_chunk_tokens=16, spill_tier="disk")


def _factory(model, spill_dir, **over):
    cfg = dict(_CFG, spill_dir=spill_dir)
    cfg.update(over)

    def factory(engine_id, registry):
        return ServingEngine(model, metrics=registry, device="cpu", **cfg)

    return factory


def _prompts(seed, n=6, lo=9, hi=20):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 128, size=rng.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


def _single_engine_reference(model, spill_dir, prompts, max_new, rids):
    eng = _factory(model, spill_dir)(None, None)
    streams = [eng.submit(p, max_new, request_id=r)
               for p, r in zip(prompts, rids)]
    while eng.pump(1):
        pass
    want = [list(map(int, s.status.tokens)) for s in streams]
    eng.shutdown(drain=False)
    return want


class _ScriptedSLO:
    """Alerts exactly on the scripted ticks (the dwell/clear pins need no
    latency choreography)."""

    def __init__(self, alert_ticks):
        self.alert_ticks = set(alert_ticks)
        self.tick = 0

    def alerting_names(self):
        return ["ttft"] if self.tick in self.alert_ticks else []

    def note_tick(self):
        self.tick += 1

    def observe_latency(self, kind, v):
        pass

    def observe_terminal(self, state):
        pass

    def bind_metrics(self, registry):
        pass

    def health_summary(self):
        return {"alerts_active": 0, "alerting": [], "ticks": self.tick}

    def snapshot(self):
        return {"ticks": self.tick}


# -- 1. identity ---------------------------------------------------------

def test_fleet_byte_identical_to_single_engine(pair, model, tmp_path):
    prompts = _prompts(0)
    rids = ["f%d" % i for i in range(len(prompts))]
    want = _single_engine_reference(model, str(tmp_path / "ref"), prompts,
                                    10, rids)
    ref = RefEngines(pair[0]).run(
        prompts, [10] * len(prompts), ids=rids,
        **dict(_CFG, spill_dir=str(tmp_path / "ref-jax")))
    for p, w, st in zip(prompts, want, ref):
        assert_greedy_equal(model, p, w, st.tokens, st.request_id)
    fleet = ServingFleet(_factory(model, str(tmp_path / "s")), engines=2)
    streams = [fleet.submit(p, 10) for p in prompts]
    # automatic ids are the fleet's, collision-free across engines
    assert [s.request_id for s in streams] == rids
    while fleet.pump(1):
        pass
    got = [list(map(int, s.status.tokens)) for s in streams]
    assert got == want
    assert all(s.status.state == RequestState.DONE for s in streams)
    per_engine = fleet.render_prometheus()
    assert 'serving_requests_submitted_total{engine="e0"}' in per_engine
    assert 'serving_requests_submitted_total{engine="e1"}' in per_engine
    fleet.shutdown(drain=False)


# -- 2. routing ----------------------------------------------------------

def test_affinity_routes_to_resident_prefix_owner(model, tmp_path):
    fleet = ServingFleet(_factory(model, str(tmp_path / "s"), slots=4,
                                  prefix_sharing=True), engines=2)
    rng = np.random.RandomState(1)
    head = rng.randint(1, 128, size=24).astype(np.int32)
    first = fleet.submit(np.concatenate(
        [head, rng.randint(1, 128, size=6).astype(np.int32)]), 20)
    fleet.pump(6)  # head blocks indexed; the request still decoding
    owner = fleet._records[first.request_id].engine_id
    buf = io.StringIO()
    with slog.logging_to(buf):
        peers = [fleet.submit(np.concatenate(
            [head, rng.randint(1, 128, size=4).astype(np.int32)]), 4)
            for _ in range(3)]
    assert all(fleet._records[p.request_id].engine_id == owner
               for p in peers)
    assert fleet._routed["affinity"].value == 3
    routed = [json.loads(ln) for ln in buf.getvalue().splitlines()
              if '"fleet.route"' in ln]
    assert [r["reason"] for r in routed] == ["affinity"] * 3
    assert all(r["engine"] == owner and r["matched_blocks"] >= 3
               for r in routed)
    while fleet.pump(1):
        pass
    # the routing hint cashed out as real prefix-cache hits
    assert fleet.engines()[owner].prefix_stats()["hits"] >= 3
    fleet.shutdown(drain=False)


def test_cold_traffic_load_balances_and_duplicates_refused(model,
                                                           tmp_path):
    fleet = ServingFleet(_factory(model, str(tmp_path / "s")), engines=2)
    prompts = _prompts(3, n=4)
    streams = [fleet.submit(p, 6, request_id="r%d" % i)
               for i, p in enumerate(prompts)]
    assert fleet._routed["load"].value == 4
    assert fleet._routed["affinity"].value == 0
    owners = {fleet._records[s.request_id].engine_id for s in streams}
    assert owners == {"e0", "e1"}
    with pytest.raises(DuplicateRequestError):
        fleet.submit(prompts[0], 6, request_id="r0")
    while fleet.pump(1):
        pass
    assert all(s.status.state == RequestState.DONE for s in streams)
    fleet.shutdown(drain=False)
    with pytest.raises(PreconditionNotMetError):
        fleet.submit(prompts[0], 4)


# -- 3. graceful migration -----------------------------------------------

def test_retire_engine_migrates_live_requests_byte_identical(model,
                                                             tmp_path):
    prompts = _prompts(4)
    rids = ["g%d" % i for i in range(len(prompts))]
    want = _single_engine_reference(model, str(tmp_path / "ref"), prompts,
                                    10, rids)
    fleet = ServingFleet(_factory(model, str(tmp_path / "s")), engines=2)
    streams = [fleet.submit(p, 10, request_id=r)
               for p, r in zip(prompts, rids)]
    fleet.pump(4)  # decode underway on both engines
    victim_eid = next(r.engine_id for r in fleet._records.values())
    survivor = fleet.engines()["e1" if victim_eid == "e0" else "e0"]
    survivor_counts = survivor.compile_counts()
    n_victims = sum(1 for r in fleet._records.values()
                    if r.engine_id == victim_eid)
    donor = fleet.engines()[victim_eid]
    decoding = [r for r in donor._live.values()
                if donor.request_state(r.rid) == RequestState.DECODING]
    stats = donor.cache_stats()
    want_bytes = stats["pool_bytes"] // stats["num_blocks"] * sum(
        -(-(len(r.prompt) + len(r.tokens) - 1) // stats["block_size"])
        for r in decoding)
    spilled0 = donor._c_spill_bytes.value
    out = fleet.retire_engine(victim_eid, reason="test-drain")
    assert out["migrated"] == n_victims
    # every decoding victim rode its detached file (no re-prefill), each
    # file its written blocks
    assert 1 <= out["adopted_from_file"] == len(decoding) <= n_victims
    assert donor._c_spill_bytes.value - spilled0 == want_bytes
    assert fleet.engine_states()[victim_eid] == "retired"
    assert fleet._c_migrations.value == n_victims
    while fleet.pump(1):
        pass
    got = [list(map(int, s.status.tokens)) for s in streams]
    assert got == want
    assert survivor.compile_counts() == survivor_counts
    assert fleet.health()["active_engines"] == 1
    with pytest.raises(PreconditionNotMetError):
        fleet.retire_engine(victim_eid)
    fleet.shutdown(drain=False)


def test_retire_last_loaded_engine_refused(model, tmp_path):
    fleet = ServingFleet(_factory(model, str(tmp_path / "s")), engines=1)
    s = fleet.submit(_prompts(5, n=1)[0], 8)
    fleet.pump(2)
    with pytest.raises(PreconditionNotMetError):
        fleet.retire_engine("e0")
    fleet.cancel(s.request_id)
    fleet.shutdown(drain=False)


# -- 4. chaos: engine death mid-burst ------------------------------------

@pytest.mark.parametrize("seed", range(5))
def test_chaos_engine_death_mid_burst_byte_identical(model, tmp_path, seed):
    prompts = _prompts(10 + seed)
    rids = ["c%d" % i for i in range(len(prompts))]
    want = _single_engine_reference(model, str(tmp_path / "ref"), prompts,
                                    10, rids)
    fleet = ServingFleet(_factory(model, str(tmp_path / "s")), engines=2,
                         min_engines=1)
    streams = [fleet.submit(p, 10, request_id=r)
               for p, r in zip(prompts, rids)]
    fleet.pump(3)
    victim_eid = next(r.engine_id for r in fleet._records.values())
    survivor_eid = "e1" if victim_eid == "e0" else "e0"
    n_victims = sum(1 for r in fleet._records.values()
                    if r.engine_id == victim_eid)
    assert n_victims >= 1
    survivor_compiles = fleet.engines()[survivor_eid].compile_counts()
    migrated = fleet.hard_abandon(victim_eid, error="chaos")
    assert len(migrated) == n_victims
    assert fleet.engine_states()[victim_eid] == "dead"
    # the dead engine gave its memory back at once
    assert fleet.engines()[victim_eid].pool._cache is None
    while fleet.pump(1):
        pass
    got = [list(map(int, s.status.tokens)) for s in streams]
    assert got == want
    assert all(s.status.state == RequestState.DONE for s in streams)
    assert fleet._c_deaths.value == 1
    assert fleet._c_migrations.value == n_victims
    h = fleet.health()
    assert h["healthy"] and h["engine_deaths"] == 1
    assert h["migrations"] == n_victims
    assert h["engines"][victim_eid] == {"healthy": False, "state": "dead"}
    assert fleet.engines()[survivor_eid].compile_counts() \
        == survivor_compiles
    fleet.shutdown(drain=False)


def test_engine_death_with_no_survivor_fails_requests_honestly(model,
                                                               tmp_path):
    fleet = ServingFleet(_factory(model, str(tmp_path / "s")), engines=1,
                         min_engines=1)
    # the replacement factory fails, so the death leaves no engine
    fleet._factory = lambda eid, reg: (_ for _ in ()).throw(
        RuntimeError("factory down"))
    s = fleet.submit(_prompts(6, n=1)[0], 8)
    fleet.pump(2)
    fleet.hard_abandon("e0", error="chaos")
    st = s.status
    assert st.state == RequestState.FAILED
    assert "no healthy engine" in st.error
    assert fleet.live_requests == 0
    fleet.shutdown(drain=False)


# -- 5. autoscaling ------------------------------------------------------

def test_autoscale_dwell_and_clear_discipline(model, tmp_path):
    slo = _ScriptedSLO(alert_ticks=range(0, 10))
    fleet = ServingFleet(_factory(model, str(tmp_path / "s")), engines=1,
                         min_engines=1, max_engines=2, slo=slo,
                         autoscale=True, scale_dwell_ticks=3,
                         scale_clear_ticks=5, scale_down_util=0.9)
    history = []
    for _ in range(25):
        fleet.pump(1)
        history.append(len(fleet._active_handles()))
    assert history[0] == 1 and max(history) == 2 and history[-1] == 1
    assert fleet._c_scale_ups.value == 1
    assert fleet._c_scale_downs.value == 1
    spawn_tick = history.index(2)
    assert spawn_tick >= 2  # dwell honored: not on the first alert
    retire_tick = len(history) - 1 - history[::-1].index(2) + 1
    assert retire_tick - (max(slo.alert_ticks) - 1) >= 5
    fleet.shutdown(drain=False)


def test_autoscale_never_exceeds_max_engines(model, tmp_path):
    slo = _ScriptedSLO(alert_ticks=range(0, 40))
    fleet = ServingFleet(_factory(model, str(tmp_path / "s")), engines=1,
                         min_engines=1, max_engines=3, slo=slo,
                         autoscale=True, scale_dwell_ticks=2,
                         scale_clear_ticks=4)
    for _ in range(30):
        fleet.pump(1)
    assert len(fleet._active_handles()) == 3
    assert fleet._c_scale_ups.value == 2
    fleet.shutdown(drain=False)


# -- 6. aggregated exposition --------------------------------------------

_PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? -?[0-9.e+-]+(inf)?$")


def test_metrics_exposition_round_trip(model, tmp_path):
    fleet = ServingFleet(_factory(model, str(tmp_path / "s")), engines=2)
    streams = [fleet.submit(p, 6) for p in _prompts(7, n=4)]
    while fleet.pump(1):
        pass
    lines = fleet.render_prometheus().splitlines()
    for line in lines:
        assert line.startswith("#") or _PROM_LINE.match(line), line
    types = [ln for ln in lines if ln.startswith("# TYPE ")]
    assert len(types) == len({ln.split()[2] for ln in types})
    sub = [ln for ln in lines
           if ln.startswith("serving_requests_submitted_total")]
    unlabeled = [ln for ln in sub if "{" not in ln]
    assert len(unlabeled) == 1  # the fleet's own front counter
    assert float(unlabeled[0].split()[-1]) == 4.0
    per_engine = {ln for ln in sub if 'engine="' in ln}
    assert len(per_engine) == 2
    assert sum(float(ln.split()[-1]) for ln in per_engine) == 4.0
    assert any('fleet_requests_routed_total{reason="load"}' in ln
               for ln in lines)
    assert any('fleet_requests_routed_total{reason="affinity"}' in ln
               for ln in lines)
    assert any(ln.startswith("serving_ttft_seconds_bucket{engine=")
               and 'le="' in ln for ln in lines)
    assert any(ln.startswith('serving_ttft_seconds_bucket{le="')
               for ln in lines)
    # every engine exports the cost gauges
    assert any(ln.startswith('serving_step_flops{engine="e0"}')
               for ln in lines)
    assert all(s.status.state == RequestState.DONE for s in streams)
    fleet.shutdown(drain=False)


# -- 7. aggregated health/slo + supervision fan-in -----------------------

def test_fleet_health_and_slo_aggregation(model, tmp_path):
    fleet = ServingFleet(_factory(model, str(tmp_path / "s")), engines=2)
    with pytest.raises(PreconditionNotMetError):
        fleet.slo_snapshot()
    h = fleet.health()
    assert h["healthy"] and h["state"] == "idle"
    assert h["active_engines"] == 2 and h["live_requests"] == 0
    assert set(h["engines"]) == {"e0", "e1"}
    assert all(e["healthy"] for e in h["engines"].values())
    # the adapter registry forwards the engines' typed refusal (no bank)
    assert fleet.engines()["e0"].has_adapter(0)
    assert not fleet.engines()["e0"].has_adapter(1)
    with pytest.raises(InvalidArgumentError, match="LoRA"):
        fleet.register_adapter(1, {})
    with pytest.raises(InvalidArgumentError, match="adapter 1"):
        fleet.submit(_prompts(1, n=1)[0], 4, adapter=1)
    assert fleet.adapters == ()
    fleet.shutdown(drain=False)
    assert not fleet.health()["healthy"]

    slo = _ScriptedSLO(alert_ticks=())
    fleet2 = ServingFleet(_factory(model, str(tmp_path / "s2")), engines=1,
                          slo=slo)
    assert "engines" in fleet2.slo_snapshot()
    fleet2.shutdown(drain=False)


def test_fleet_supervisor_escalates_wedged_engine(model, tmp_path):
    fleet = ServingFleet(_factory(model, str(tmp_path / "s")), engines=2,
                         min_engines=1)
    s = fleet.submit(_prompts(8, n=1)[0], 10)
    fleet.pump(2)
    owner = fleet._records[s.request_id].engine_id
    sup = FleetSupervisor(fleet, stall_timeout_s=0.01,
                          escalate_timeout_s=0.02)
    assert sup.check_once() == {}
    # wedge the owner: a tick that started long ago and never finished
    wedged = fleet.engines()[owner]._health
    wedged.tick_finished_at = -1.0
    wedged.note_tick_start(0.0)
    actions = sup.check_once()
    assert actions[owner][-1] == "engine-abandoned"
    assert "stall-detected" in actions[owner]
    assert fleet.engine_states()[owner] == "dead"
    while fleet.pump(1):
        pass
    assert s.status.state == RequestState.DONE
    assert sup.check_once() == {}
    fleet.shutdown(drain=False)


def test_fleet_supervisor_abandons_engine_wedged_inside_pump(model,
                                                            tmp_path):
    """A tick that really blocks (inside ``fleet.pump()`` on another
    thread) leaves the fleet free: the started supervisor abandons the
    engine, its request finishes on the survivor with one engine's
    tokens, and the wedged engine's memory is given back once its tick
    lets go."""
    prompt = _prompts(8, n=1)[0]
    want = _single_engine_reference(model, str(tmp_path / "ref"), [prompt],
                                    10, ["f0"])[0]
    fleet = ServingFleet(_factory(model, str(tmp_path / "s")), engines=2,
                         min_engines=1)
    s = fleet.submit(prompt, 10)
    fleet.pump(2)
    owner = fleet._records[s.request_id].engine_id
    survivor = [e for e in fleet.engine_states() if e != owner][0]
    wedged = fleet.engines()[owner]
    entered, release = threading.Event(), threading.Event()

    def blocked_step():
        entered.set()
        release.wait(30.0)

    wedged._pool.step = blocked_step
    errors = []

    def pumper():
        try:
            fleet.pump(1)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    t = threading.Thread(target=pumper, daemon=True)
    sup = FleetSupervisor(fleet, stall_timeout_s=0.05,
                          escalate_timeout_s=0.1, poll_interval_s=0.01)
    try:
        t.start()
        assert entered.wait(10.0)
        sup.start()
        limit = time.monotonic() + 10.0
        while fleet.engine_states()[owner] != "dead" \
                and time.monotonic() < limit:
            time.sleep(0.01)
        with fleet._lock:  # the abandon's migration has completed
            assert fleet.engine_states()[owner] == "dead"
            assert fleet._records[s.request_id].engine_id == survivor
        # the survivor's own ticks may outlast the tight escalation limit
        # on a loaded host: supervision has done its part
        sup.stop()
        # the tick still runs: the engine keeps its memory until it ends
        assert wedged._pool._cache is not None
        while fleet.pump(1):
            pass
        assert s.status.state == RequestState.DONE, s.status
        assert list(map(int, s.status.tokens)) == want
    finally:
        sup.stop()
        release.set()
        t.join(10.0)
    assert not t.is_alive() and errors == []
    assert wedged._pool._cache is None
    fleet.shutdown(drain=False)


def test_release_device_refused_while_loop_runs(model):
    eng = ServingEngine(model, device="cpu", max_len=64, slots=2,
                        buckets=[64])
    eng.start()
    try:
        with pytest.raises(PreconditionNotMetError):
            eng.release_device()
        assert eng._pool._cache is not None
    finally:
        eng.shutdown(drain=False)


def test_cancel_frees_engine_and_front(model, tmp_path):
    fleet = ServingFleet(_factory(model, str(tmp_path / "s")), engines=2)
    s = fleet.submit(_prompts(9, n=1)[0], 30)
    fleet.pump(3)
    owner = fleet._records[s.request_id].engine_id
    assert fleet.cancel(s.request_id) is True
    assert s.status.state == RequestState.CANCELLED
    assert fleet.cancel(s.request_id) is False
    fleet.pump(2)
    assert fleet.engines()[owner].live_requests == 0
    assert fleet.live_requests == 0
    fleet.shutdown(drain=False)


# -- 8. across the packages ----------------------------------------------

def _route_trace(fleet_cls, factory, log_mod, traffic):
    """Drive ``traffic`` (prompts with the pumps between them) through a
    3-engine fleet; return the routing decisions in order."""
    clock = FakeClock()
    fleet = fleet_cls(factory, engines=3, clock=clock)
    buf = io.StringIO()
    with log_mod.logging_to(buf):
        for prompt, budget, pumps in traffic:
            fleet.submit(prompt, budget)
            for _ in range(pumps):
                fleet.pump(1)
                clock.advance(0.01)
        while fleet.pump(1):
            clock.advance(0.01)
    fleet.shutdown(drain=False)
    return [(r["rid"], r["engine"], r["reason"], r["matched_blocks"])
            for r in (json.loads(ln) for ln in buf.getvalue().splitlines())
            if r["event"] == "fleet.route"]


def test_route_decisions_match_reference_fleet(pair, tmp_path):
    """The same traffic (two shared heads with their own tails, cold
    prompts between) under a fake clock: the reference's fleet and the
    port's place every request on the same engine for the same reason."""
    from paddle_tpu.serving import ServingEngine as RefEngine
    from paddle_tpu.serving import ServingFleet as RefFleet
    from paddle_tpu.serving import log as ref_slog

    ref, port = pair
    rng = np.random.RandomState(21)
    heads = [rng.randint(1, 128, size=24).astype(np.int32)
             for _ in range(2)]
    traffic = []
    for i in range(10):
        if i % 3 == 2:
            p = rng.randint(1, 128, size=rng.randint(9, 20))
        else:
            p = np.concatenate([heads[i % 2], rng.randint(
                1, 128, size=rng.randint(3, 8))])
        traffic.append((p.astype(np.int32), 12, 3))
    cfg = dict(_CFG, slots=3, prefix_sharing=True)

    def ref_factory(eid, reg):
        return RefEngine(ref, metrics=reg,
                         **dict(cfg, spill_dir=str(tmp_path / "r")))

    got = _route_trace(ServingFleet,
                       _factory(port, str(tmp_path / "p"), slots=3,
                                prefix_sharing=True), slog, traffic)
    want = _route_trace(RefFleet, ref_factory, ref_slog, traffic)
    assert got == want
    reasons = {r[2] for r in got}
    assert reasons == {"affinity", "load"}
