"""The port's request-scoped tracing and tick flight recorder,
re-pointed from the reference's ``tests/test_trace.py`` (its
speculative-engine case is in ``tests/test_torch_speculative.py``) and held
against the reference's engine on the same weights (CPU).

1. tracing OFF is a no-op: an uninstalled tracer stays untouched by a
   full serving run;
2. a chaos-seeded run's flight recorder reconciles with the plane and the
   recovery counters, and its injection/recovery events are the
   reference's under the same seed;
3. the Chrome export round-trips through ``json.loads`` with ordered
   tracks and closed request timelines;
4. the ring is bounded and its overflow counted;
5. the deep-timing flag rides every span (on the card deep timing also
   synchronizes the stream at the prefill and decode span edges);
6. drain and shutdown close every request timeline.
"""
import json

import numpy as np
import pytest

from paddle_tpu.serving import ServingEngine as RefEngine
from paddle_tpu.serving import faults as ref_faults
from paddle_tpu.serving import trace as ref_trace
from torch_parity import (SMALL, FakeClock, RefEngines, assert_greedy_equal,
                          build_pair)

from paddle_tpu_torch.core.errors import (InvalidArgumentError,
                                          NotFoundError,
                                          PreconditionNotMetError)
from paddle_tpu_torch.serving import (DeadlineUnattainableError,
                                      MetricsRegistry, RequestState,
                                      ServingEngine, Supervisor, faults,
                                      trace)
from paddle_tpu_torch.serving.faults import FaultPlane
from paddle_tpu_torch.serving.trace import FlightRecorder, TraceEvent, Tracer


@pytest.fixture(scope="module")
def pair():
    return build_pair(**SMALL)


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


@pytest.fixture(scope="module")
def refs(pair):
    return RefEngines(pair[0])


@pytest.fixture(autouse=True)
def _no_leaked_tracer():
    yield
    trace.uninstall()
    faults.uninstall()
    ref_trace.uninstall()
    ref_faults.uninstall()


def _engine(model, **kw):
    kw.setdefault("max_len", 64)
    kw.setdefault("slots", 2)
    kw.setdefault("buckets", [32])
    return ServingEngine(model, device="cpu", **kw)


def _run(eng, prompts, budget):
    streams = [eng.submit(p, budget) for p in prompts]
    while eng.pump(8):
        pass
    return [s.result(timeout_s=0) for s in streams]


def _prompts(n=3, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (k,)).astype("int32")
            for k in (5, 9, 7, 4, 6)[:n]]


def _traced_ref(ref_model, prompts, budget, capacity=1024, **kw):
    """The reference engine's traced run of the same traffic: its
    statuses and its recorder's events."""
    eng = RefEngine(ref_model, max_len=64, slots=2, buckets=[32], **kw)
    tracer = eng.start_trace(capacity=capacity)
    try:
        statuses = _run(eng, prompts, budget)
    finally:
        eng.stop_trace()
    return statuses, tracer.recorder.snapshot(), eng


# -- 1. tracing off is a no-op ---------------------------------------------------
def test_trace_off_buffer_untouched(model, refs):
    tracer = Tracer(capacity=64)  # built, never installed
    eng = _engine(model)
    statuses = _run(eng, _prompts(2), 5)
    ref = refs.run(_prompts(2), [5, 5], max_len=64, slots=2, buckets=[32])
    for p, st, r in zip(_prompts(2), statuses, ref):
        assert_greedy_equal(model, p, st.tokens, r.tokens)
    assert len(tracer.recorder) == 0
    assert tracer.recorder.total_events == 0
    assert tracer.recorder.dropped == 0
    assert trace.active() is None
    assert eng._tracer is None
    assert eng.metrics.snapshot()["serving_trace_events_dropped_total"] == 0


def test_module_instant_is_noop_when_off():
    trace.instant("req.queued", rid="x")
    assert trace.active() is None


# -- lifecycle and phases ----------------------------------------------------------
def test_lifecycle_and_phase_events(pair):
    ref_model, model = pair
    eng = _engine(model)
    tracer = eng.start_trace(capacity=1024)
    try:
        statuses = _run(eng, _prompts(2), 5)
    finally:
        eng.stop_trace()
    assert all(st.state == RequestState.DONE for st in statuses)
    evs = tracer.recorder.snapshot()
    names = {e.name for e in evs}
    for phase in ("tick", "tick.admit", "tick.prefill", "tick.decode",
                  "tick.sample", "tick.deliver"):
        assert phase in names, phase
    for st in statuses:
        mine = [e for e in evs if e.rid == st.request_id]
        life = [e.name for e in mine if e.name.startswith("req.")]
        assert life == ["req.queued", "req.prefilling", "req.decoding",
                        "req.done"]
        ts = [e.ts for e in mine]
        assert ts == sorted(ts)
    spans = [e for e in evs if e.dur_s is not None]
    assert spans and all(e.dur_s >= 0 for e in spans)
    assert all(e.deep is False for e in spans)
    ticks = [e.meta["tick"] for e in evs if e.name == "tick"]
    assert ticks == list(range(1, len(ticks) + 1))
    assert "compile" in names
    # the same event sequence, name for name, as the reference's run
    _, ref_evs, _ = _traced_ref(ref_model, _prompts(2), 5)
    assert [(e.name, e.rid) for e in evs] == \
        [(e.name, e.rid) for e in ref_evs]
    assert [e.meta for e in evs if e.name == "compile"] == \
        [e.meta for e in ref_evs if e.name == "compile"]


def test_deep_timing_flag_rides_every_span(model):
    eng = _engine(model)
    tracer = eng.start_trace(capacity=1024, deep_timing=True)
    try:
        statuses = _run(eng, _prompts(1), 4)
    finally:
        eng.stop_trace()
    assert statuses[0].state == RequestState.DONE
    spans = [e for e in tracer.recorder.snapshot() if e.dur_s is not None]
    assert spans and all(e.deep is True for e in spans)
    d = json.loads(eng.export_chrome_trace())
    phase_spans = [e for e in d["traceEvents"]
                   if e.get("ph") == "X" and e.get("cat") == "phase"]
    assert phase_spans
    assert all(e["args"]["deep"] is True for e in phase_spans)


# -- ring bounds and drops ------------------------------------------------------------
def test_ring_bounded_and_drops_counted(model):
    eng = _engine(model)
    tracer = eng.start_trace(capacity=8)
    try:
        _run(eng, _prompts(3), 6)
    finally:
        eng.stop_trace()
    rec = tracer.recorder
    assert len(rec) <= 8
    assert rec.dropped > 0
    assert rec.total_events == len(rec) + rec.dropped
    assert eng.metrics.snapshot()[
        "serving_trace_events_dropped_total"] == rec.dropped
    assert len(rec.snapshot()) == len(rec)


def test_recorder_validates_capacity():
    with pytest.raises(InvalidArgumentError, match="capacity"):
        FlightRecorder(0)


def test_install_refuses_stacking():
    t = Tracer()
    with trace.tracing(t):
        with pytest.raises(PreconditionNotMetError, match="already"):
            trace.install(Tracer())
        # the reference's tracer is a different process-global
        assert ref_trace.active() is None
    assert trace.active() is None


def test_stop_trace_refuses_to_kill_another_engines_tracer(model):
    eng1 = _engine(model)
    eng2 = _engine(model)
    eng2.start_trace()
    eng2.stop_trace()
    t1 = eng1.start_trace()
    try:
        with pytest.raises(PreconditionNotMetError, match="not this"):
            eng2.stop_trace()
        assert trace.active() is t1
        eng3 = _engine(model)
        with pytest.raises(PreconditionNotMetError, match="not this"):
            eng3.stop_trace()
        assert trace.active() is t1
    finally:
        assert eng1.stop_trace() is t1
    assert trace.active() is None
    assert eng1.stop_trace() is None


# -- chrome export -----------------------------------------------------------------------
def test_chrome_export_roundtrip_and_track_ordering(model):
    eng = _engine(model, cache_layout="paged", block_size=8)
    eng.start_trace(capacity=2048)
    try:
        statuses = _run(eng, _prompts(3), 5)
    finally:
        eng.stop_trace()
    d = json.loads(eng.export_chrome_trace())
    evs = d["traceEvents"]
    assert d["displayTimeUnit"] == "ms"
    per_track = {}
    for e in evs:
        if "ts" in e:
            per_track.setdefault((e["pid"], e["tid"]), []).append(e["ts"])
    assert per_track
    for ts in per_track.values():
        assert ts == sorted(ts)
    req_threads = [e for e in evs if e.get("ph") == "M"
                   and e["name"] == "thread_name" and e["pid"] == 1]
    assert len(req_threads) == len(statuses)
    life = [e for e in evs if e.get("cat") == "lifecycle"]
    assert not any(e.get("args", {}).get("open") for e in life)
    terminals = [e for e in life if e.get("ph") == "i"]
    assert len(terminals) == len(statuses)
    assert all(e["name"] == "DONE" for e in terminals)
    phase_names = {e["name"] for e in evs if e.get("cat") == "phase"}
    assert {"tick", "tick.decode"} <= phase_names
    # the converter is the reference's: the same snapshot exports the
    # same document
    snap = eng._tracer.recorder.snapshot()
    ref_events = [ref_trace.TraceEvent(e.ts, e.name, e.rid, e.dur_s, e.deep,
                                       e.meta) for e in snap]
    assert trace.to_chrome_events(snap) == \
        ref_trace.to_chrome_events(ref_events)


def test_export_writes_path(model, tmp_path):
    eng = _engine(model)
    eng.start_trace()
    try:
        _run(eng, _prompts(1), 3)
    finally:
        eng.stop_trace()
    p = str(tmp_path / "trace.json")
    js = eng.export_chrome_trace(path=p)
    with open(p) as f:
        assert json.load(f) == json.loads(js)


def test_export_without_tracer_is_typed(model):
    eng = _engine(model)
    with pytest.raises(PreconditionNotMetError, match="start_trace"):
        eng.export_chrome_trace()
    with pytest.raises(PreconditionNotMetError):
        eng.flight_recorder()


def test_request_trace_lookup_and_404(model):
    eng = _engine(model)
    eng.start_trace()
    try:
        _run(eng, [_prompts(1)[0]], 3)  # auto rid 0
    finally:
        eng.stop_trace()
    tl = eng.request_trace(0)
    assert tl["request_id"] == 0
    assert [e["name"] for e in tl["events"]][-1] == "req.done"
    assert eng.request_trace("0")["events"] == tl["events"]
    with pytest.raises(NotFoundError, match="nope"):
        eng.request_trace("nope")


# -- 2. chaos reconciliation ---------------------------------------------------------------
CHAOS_POINTS = ("pool.step", "pool.alloc_blocks", "stream.deliver")
CHAOS = dict(max_len=64, slots=2, buckets=[32], cache_layout="paged",
             block_size=8, max_retries=8)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_chaos_flight_recorder_reconciles(model, refs, seed):
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, 128, (n,)).astype("int32")
               for n in (5, 9, 7, 4)]
    clean = ServingEngine(model, device="cpu", **CHAOS)
    want = {st.request_id: st.tokens for st in _run(clean, prompts, 6)}

    eng = ServingEngine(model, device="cpu", **CHAOS)
    tracer = eng.start_trace(capacity=4096)
    plane = FaultPlane(chaos_seed=seed, chaos_p=0.08,
                       chaos_points=CHAOS_POINTS, max_faults=6)
    try:
        with faults.injected(plane):
            statuses = _run(eng, prompts, 6)
    finally:
        eng.stop_trace()
    evs = tracer.recorder.snapshot()
    snap = eng.metrics.snapshot()
    for st in statuses:
        assert st.state == RequestState.DONE, (seed, st.state, st.error)
        np.testing.assert_array_equal(st.tokens, want[st.request_id])

    injected = [e for e in evs if e.name == "fault.injected"]
    assert len(injected) == plane.fault_count
    assert [(e.meta["point"], e.meta["hit"], e.meta["error"])
            for e in injected] == list(plane.injected)
    recoveries = [e for e in evs if e.name == "recovery"]
    assert len(recoveries) == snap["serving_recoveries_total"]
    resubmits = [e for e in evs if e.name == "recovery.resubmit"]
    assert len(resubmits) == snap["serving_requests_recovered_total"]
    for ev in resubmits:
        assert [i for i in injected if i.ts <= ev.ts], \
            "resubmit with no prior injection event"
        done = [e for e in evs if e.rid == ev.rid and e.name == "req.done"]
        assert done and done[-1].ts >= ev.ts
    d = json.loads(eng.export_chrome_trace())
    per_track = {}
    for e in d["traceEvents"]:
        if "ts" in e:
            per_track.setdefault((e["pid"], e["tid"]), []).append(e["ts"])
    for ts in per_track.values():
        assert ts == sorted(ts)

    # the reference under the same seed: the same injections, the same
    # recoveries and resubmissions, the same tokens
    ref_eng = refs.engine(**CHAOS)
    rtracer = ref_eng.start_trace(capacity=4096)
    rplane = ref_faults.FaultPlane(chaos_seed=seed, chaos_p=0.08,
                                   chaos_points=CHAOS_POINTS, max_faults=6)
    try:
        with ref_faults.injected(rplane):
            ref_statuses = _run(ref_eng, prompts, 6)
    finally:
        ref_eng.stop_trace()
    revs = rtracer.recorder.snapshot()
    assert plane.injected == rplane.injected
    for name in ("fault.injected", "recovery"):
        assert [e.meta for e in evs if e.name == name] == \
            [e.meta for e in revs if e.name == name], name
    assert [e.meta["committed_tokens"] for e in resubmits] == \
        [e.meta["committed_tokens"] for e in revs
         if e.name == "recovery.resubmit"]
    for p, st, r in zip(prompts, statuses, ref_statuses):
        assert_greedy_equal(model, p, st.tokens, r.tokens, seed)


# -- supervision post-mortem dumps ------------------------------------------------------------
def test_stall_dumps_flight_recorder_into_health(model):
    clock = FakeClock()
    eng = _engine(model, clock=clock)
    sup = Supervisor(eng, stall_timeout_s=0.5, clock=clock)
    eng.start_trace(capacity=256)
    try:
        _run(eng, _prompts(1), 3)
        assert eng.health()["flight_dump"] is None
        clock.advance(0.001)
        eng._health.note_tick_start(clock())
        clock.advance(1.0)
        assert sup.check_once() == ["stall-detected"]
    finally:
        eng.stop_trace()
    h = eng.health()
    dump = h["flight_dump"]
    assert dump is not None and dump["reason"] == "stall-detected"
    assert dump["events"]
    assert dump["at"] == clock()
    assert dump["trace_now"] >= max(e["ts"] for e in dump["events"])
    assert "tick" in [e["name"] for e in dump["events"]]
    json.dumps(h)
    assert any(e.name == "stall" for e in eng._tracer.recorder.snapshot())


def test_stall_without_tracer_dumps_nothing(model):
    clock = FakeClock()
    eng = _engine(model, clock=clock)
    sup = Supervisor(eng, stall_timeout_s=0.5, clock=clock)
    eng._health.note_tick_start(clock())
    clock.advance(1.0)
    assert sup.check_once() == ["stall-detected"]
    assert eng.health()["flight_dump"] is None


# -- 6. drain and shutdown close every timeline ------------------------------------------------
def test_shutdown_cancel_emits_terminal_events(model):
    eng = _engine(model)
    tracer = eng.start_trace(capacity=1024)
    try:
        streams = [eng.submit(p, 20) for p in _prompts(2)]
        eng.pump(2)
        eng.shutdown(drain=False)
    finally:
        eng.stop_trace()
    evs = tracer.recorder.snapshot()
    for s in streams:
        terminal = [e for e in evs if e.rid == s.request_id
                    and e.name in trace.TERMINAL_EVENTS]
        assert terminal, "shutdown left a request timeline open"
        assert terminal[-1].name == "req.cancelled"
    d = json.loads(eng.export_chrome_trace())
    life = [e for e in d["traceEvents"] if e.get("cat") == "lifecycle"]
    assert life and not any(e.get("args", {}).get("open") for e in life)


def test_drain_emits_terminal_events(model):
    eng = _engine(model)
    tracer = eng.start_trace(capacity=1024)
    try:
        streams = [eng.submit(p, 4) for p in _prompts(2)]
        assert eng.drain() is True
    finally:
        eng.stop_trace()
    evs = tracer.recorder.snapshot()
    for s in streams:
        assert any(e.rid == s.request_id and e.name == "req.done"
                   for e in evs)


# -- metrics reset, shed and expiry events -------------------------------------------------------
def test_metrics_reset_all():
    m = MetricsRegistry()
    c = m.counter("c_total", "x")
    g = m.gauge("g", "x")
    h = m.histogram("h_seconds", "x", buckets=(0.1, 1.0))
    c.inc(3)
    g.set(7.5)
    h.observe(0.05)
    h.observe(2.0)
    m.reset_all()
    snap = m.snapshot()
    assert snap["c_total"] == 0.0 and snap["g"] == 0.0
    assert snap["h_seconds"]["count"] == 0 and snap["h_seconds"]["sum"] == 0.0
    assert m.counter("c_total") is c
    assert m.histogram("h_seconds", buckets=(0.1, 1.0)) is h
    c.inc()
    assert m.snapshot()["c_total"] == 1.0


def test_shed_and_expiry_events(model):
    clock = FakeClock()
    eng = _engine(model, max_len=128, slots=1, clock=clock, buckets=[32])
    tracer = eng.start_trace(capacity=1024)
    try:
        _run(eng, _prompts(1), 3)
        eng.submit(_prompts(1)[0], 100, request_id="long", deadline_s=1e6)
        eng.pump(2)
        with pytest.raises(DeadlineUnattainableError):
            eng.submit(_prompts(1)[0], 20, deadline_s=1e-9)
        clock.advance(2e6)
        eng.pump(1)
    finally:
        eng.stop_trace()
        eng.shutdown(drain=False)
    evs = tracer.recorder.snapshot()
    assert any(e.name == "shed" for e in evs)
    assert any(e.rid == "long" and e.name == "req.expired" for e in evs)


def test_recorder_tail_dicts_bounded():
    rec = FlightRecorder(capacity=100)
    ref = ref_trace.FlightRecorder(capacity=100)
    for i in range(50):
        rec.append(TraceEvent(float(i), "e%d" % i))
        ref.append(ref_trace.TraceEvent(float(i), "e%d" % i))
    tail = rec.tail_dicts(10)
    assert len(tail) == 10 and tail[-1]["name"] == "e49"
    assert tail == ref.tail_dicts(10)
    json.dumps(tail)
