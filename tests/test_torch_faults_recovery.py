"""The port's fault plane, request-level recovery, deadline shedding,
supervision and the seeded chaos harness, re-pointed from the reference's
``tests/test_faults_recovery.py`` (its speculative-engine case is in
``tests/test_torch_speculative.py``) and ``tests/test_chaos_serving.py``,
and held against the reference's engine on the same weights (CPU).

- The plane is the reference's: the same points, schedules and seeded
  chaos draws (the same seed injects at the same hits in both packages).
- A transient fault costs a pool reset and re-prefills: every greedy
  survivor finishes byte-identical to the fault-free run AND to the
  reference's recovered run under the same plane, with
  ``compile_counts()`` unchanged.
- Permanent faults and exhausted budgets end FAILED with the retry count
  and the root error; ``drain(timeout_s)`` is honoured in pump mode; the
  supervisor detects stalls and restarts dead loops.

Every wait on a thread is bounded.
"""
import time

import numpy as np
import pytest

from paddle_tpu.serving import ServingEngine as RefEngine
from paddle_tpu.serving import faults as ref_faults
from torch_parity import (SMALL, FakeClock, RefEngines, assert_greedy_equal,
                          build_pair)

from paddle_tpu_torch.core.errors import (InvalidArgumentError,
                                          NotFoundError,
                                          PreconditionNotMetError)
from paddle_tpu_torch.serving import (DeadlineUnattainableError,
                                      RequestState, ServingEngine,
                                      Supervisor, faults)
from paddle_tpu_torch.serving.faults import (FaultPlane, FaultSpec,
                                             PermanentInjectedFault,
                                             TransientInjectedFault)


@pytest.fixture(scope="module")
def pair():
    return build_pair(**SMALL)


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


@pytest.fixture(scope="module")
def refs(pair):
    return RefEngines(pair[0])


def _engine(model, **kw):
    return ServingEngine(model, device="cpu", **kw)


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (n,)).astype("int32") for n in lens]


def _pump_bounded(eng, limit=500):
    n = 0
    while eng.pump(1):
        n += 1
        assert n < limit, "engine failed to drain: wedged"
    return n


# -- the fault plane itself ----------------------------------------------------
def test_fault_spec_validation():
    with pytest.raises(InvalidArgumentError, match="fault point"):
        FaultSpec("pool.stepp", error=TransientInjectedFault)
    with pytest.raises(InvalidArgumentError, match="neither"):
        FaultSpec("pool.step")
    with pytest.raises(InvalidArgumentError, match="times"):
        FaultSpec("pool.step", error=TransientInjectedFault, times=0)
    with pytest.raises(InvalidArgumentError, match="chaos_seed"):
        FaultPlane(chaos_p=0.5)
    with pytest.raises(InvalidArgumentError, match="chaos points"):
        FaultPlane(chaos_seed=0, chaos_p=0.5, chaos_points=("nope",))
    # the vocabulary is the reference's, journal/spill/xfer included
    assert faults.POINTS == ref_faults.POINTS


def test_scripted_schedule_counts_hits_and_times():
    def run(mod):
        plane = mod.FaultPlane([mod.FaultSpec(
            "pool.step", error=mod.TransientInjectedFault, after=2,
            times=2)])
        fired = []
        for i in range(6):
            try:
                plane.fire("pool.step")
            except mod.TransientInjectedFault as e:
                fired.append((i, e.point, e.hit))
        return fired, plane.hits, plane.injected

    got = run(faults)
    assert got[0] == [(2, "pool.step", 3), (3, "pool.step", 4)]
    assert got[1]["pool.step"] == 6
    assert got == run(ref_faults)


def test_delay_spec_sleeps_and_logs():
    plane = FaultPlane([FaultSpec("pool.step", delay_s=0.05)])
    t0 = time.monotonic()
    plane.fire("pool.step")
    assert time.monotonic() - t0 >= 0.05
    plane.fire("pool.step")
    assert plane.injected == [("pool.step", 1, "delay")]


def test_chaos_mode_is_seed_deterministic_and_capped():
    def run(mod, seed):
        plane = mod.FaultPlane(chaos_seed=seed, chaos_p=0.3,
                               chaos_points=("pool.step",), max_faults=3)
        log = []
        for i in range(50):
            try:
                plane.fire("pool.step")
            except mod.TransientInjectedFault:
                log.append(i)
        return log, plane.fault_count

    log_a, n_a = run(faults, 7)
    assert (log_a, n_a) == run(faults, 7)
    assert log_a != run(faults, 8)[0]
    assert n_a == 3
    # the same seed injects at the same hits as the reference's plane
    for seed in (7, 8):
        assert run(faults, seed) == run(ref_faults, seed)


def test_install_uninstall_and_disabled_noop():
    assert faults.active() is None
    faults.fire("pool.step")
    plane = FaultPlane([FaultSpec("pool.step",
                                  error=TransientInjectedFault)])
    with faults.injected(plane):
        assert faults.active() is plane
        with pytest.raises(PreconditionNotMetError, match="installed"):
            faults.install(FaultPlane([FaultSpec(
                "pool.step", error=TransientInjectedFault)]))
        with pytest.raises(TransientInjectedFault):
            faults.fire("pool.step")
        # the reference's plane is a different process-global: untouched
        assert ref_faults.active() is None
    assert faults.active() is None
    faults.uninstall()


def test_classify_error_vocabulary():
    from paddle_tpu.core.errors import InvalidArgumentError as RefInvalid

    class Cooperating(Exception):
        transient = False

    cases = [(TransientInjectedFault(), ref_faults.TransientInjectedFault(),
              "transient"),
             (PermanentInjectedFault(), ref_faults.PermanentInjectedFault(),
              "permanent"),
             (RuntimeError("boom"), RuntimeError("boom"), "transient"),
             (OSError("reset"), OSError("reset"), "transient"),
             (InvalidArgumentError("bad"), RefInvalid("bad"), "permanent"),
             (NotFoundError("gone"), None, "permanent"),
             (Cooperating(), Cooperating(), "permanent")]
    for mine, theirs, want in cases:
        assert faults.classify_error(mine) == want
        if theirs is not None:
            assert ref_faults.classify_error(theirs) == want


# -- request-level recovery ---------------------------------------------------------
PAGED = dict(max_len=64, slots=2, buckets=[32], cache_layout="paged",
             block_size=8)


def _faulted(model, prompts, budgets, specs, **cfg):
    """The port engine over ``prompts`` under a scripted plane of
    ``specs``; returns the terminal statuses, the engine and the plane."""
    eng = _engine(model, **cfg)
    plane = FaultPlane([FaultSpec(**s) for s in specs])
    with faults.injected(plane):
        streams = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
        _pump_bounded(eng, 200)
    return [s.result(timeout_s=0) for s in streams], eng, plane


def _ref_plane(specs):
    conv = {TransientInjectedFault: ref_faults.TransientInjectedFault,
            PermanentInjectedFault: ref_faults.PermanentInjectedFault}
    return ref_faults.FaultPlane([
        ref_faults.FaultSpec(**dict(s, error=conv.get(s["error"],
                                                      s["error"])))
        for s in specs])


def test_transient_step_fault_recovers_token_identical(model, refs):
    prompts = _prompts(1, (5, 9, 7))
    budgets = [6, 6, 6]
    clean = _engine(model, **PAGED)
    cs = [clean.submit(p, n) for p, n in zip(prompts, budgets)]
    _pump_bounded(clean)
    want = [s.result(timeout_s=0).tokens for s in cs]
    base = clean.cache_stats()
    specs = [dict(point="pool.step", error=TransientInjectedFault, after=3,
                  times=1)]
    got, eng, plane = _faulted(model, prompts, budgets, specs, **PAGED)
    ref = refs.run(prompts, budgets, plane=_ref_plane(specs), **PAGED)
    assert plane.injected, "the scripted fault never fired"
    for p, st, w, r in zip(prompts, got, want, ref):
        assert st.state == RequestState.DONE == r.state
        np.testing.assert_array_equal(st.tokens, w)
        assert st.new_tokens == len(w)
        assert_greedy_equal(model, p, st.tokens, r.tokens)
    snap = eng.metrics.snapshot()
    rsnap = refs.last_engine.metrics.snapshot()
    for name in ("serving_requests_recovered_total",
                 "serving_recoveries_total",
                 "serving_requests_failed_total",
                 "serving_tokens_emitted_total"):
        assert snap[name] == rsnap[name], name
    assert snap["serving_requests_recovered_total"] == 3
    assert snap["serving_recoveries_total"] == 1
    assert snap["serving_requests_failed_total"] == 0
    assert snap["serving_tokens_emitted_total"] == sum(len(w) for w in want)
    stats = eng.cache_stats()
    assert stats["mapped_blocks"] == 0
    assert stats["free_blocks"] == base["free_blocks"]
    # recovery re-allocated, never added a step key
    assert eng.compile_counts() == clean.compile_counts()
    counts = eng.compile_counts()
    assert counts["prefill"] == 1
    assert counts["pool_decode"] == 1 and counts["slot_insert"] == 1
    h = eng.health()
    assert h["recoveries"] == 1 and h["requests_recovered"] == 3
    assert "TransientInjectedFault" in h["last_error"]
    assert h["last_error_kind"] == "transient"
    assert h["last_error_at"] is not None


@pytest.mark.parametrize("point,after", [("pool.alloc_blocks", 1),
                                         ("stream.deliver", 4),
                                         ("pool.prefill", 1)])
def test_alloc_and_deliver_faults_route_through_recovery(model, refs,
                                                         point, after):
    prompts = _prompts(2, (5, 8))
    clean = _engine(model, **PAGED)
    cs = [clean.submit(p, 5) for p in prompts]
    _pump_bounded(clean)
    want = [s.result(timeout_s=0).tokens for s in cs]
    specs = [dict(point=point, error=TransientInjectedFault, after=after,
                  times=1)]
    got, eng, plane = _faulted(model, prompts, [5, 5], specs, **PAGED)
    ref = refs.run(prompts, [5, 5], plane=_ref_plane(specs), **PAGED)
    assert any(k == "TransientInjectedFault" for _, _, k in plane.injected)
    for p, st, w, r in zip(prompts, got, want, ref):
        assert st.state == RequestState.DONE == r.state, (point, st.error)
        np.testing.assert_array_equal(st.tokens, w)
        assert_greedy_equal(model, p, st.tokens, r.tokens, point)
    assert eng.cache_stats()["mapped_blocks"] == 0
    assert eng.compile_counts() == clean.compile_counts()


@pytest.mark.parametrize("chunk", [None, 8], ids=["bucketed", "chunked"])
def test_sampled_requests_recover_their_own_streams(model, chunk):
    """A sampled request resubmitted as prompt + committed tokens draws
    its re-prefill at its committed count (the config's ``draws``), so it
    continues the uninterrupted run's stream byte for byte."""
    cfg = dict(PAGED, prefill_chunk_tokens=chunk)
    if chunk is None:
        cfg["buckets"] = [32]
    else:
        del cfg["buckets"]
    prompts = _prompts(7, (5, 9, 7))
    samp = [dict(temperature=0.9, top_k=20, seed=11 + i) for i in range(3)]

    def run(specs):
        eng = _engine(model, **cfg)
        plane = FaultPlane([FaultSpec(**s) for s in specs])
        with faults.injected(plane):
            streams = [eng.submit(p, 8, **kw)
                       for p, kw in zip(prompts, samp)]
            _pump_bounded(eng, 200)
        return [s.result(timeout_s=0) for s in streams], plane, eng

    want, _, _ = run([])
    got, plane, eng = run([dict(point="pool.step",
                                error=TransientInjectedFault, after=4,
                                times=1)])
    assert plane.injected
    assert eng.metrics.snapshot()["serving_requests_recovered_total"] == 3
    for st, w in zip(got, want):
        assert st.state == w.state == RequestState.DONE
        np.testing.assert_array_equal(st.tokens, w.tokens)


def test_permanent_fault_fails_with_retry_count_and_root_error(pair):
    ref_model, model = pair
    out = {}
    for side, eng, mod in (
            ("port", _engine(model, max_len=64, slots=2, buckets=[16]),
             faults),
            ("ref", RefEngine(ref_model, max_len=64, slots=2, buckets=[16]),
             ref_faults)):
        plane = mod.FaultPlane([mod.FaultSpec(
            "pool.step", error=mod.PermanentInjectedFault("poisoned " * 100))])
        with mod.injected(plane):
            a = eng.submit(np.zeros(4, np.int32), 6)
            while eng.pump(4):
                pass
        st = a.result(timeout_s=0)
        assert list(a) == [] and a.done()
        assert eng.cancel(a.request_id) is False
        out[side] = (st.state, st.finish_reason, st.error,
                     eng.metrics.snapshot()["serving_requests_failed_total"])
        if side == "port":
            with pytest.raises(NotFoundError):
                eng._pool.cancel(a.request_id)
            with pytest.raises(NotFoundError):
                eng._pool.collect(a.request_id)
    state, reason, error, failed = out["port"]
    assert state == RequestState.FAILED and reason == "error"
    assert "permanent" in error and "retries=0/2" in error
    assert "poisoned" in error and len(error) <= 500
    assert failed == 1
    assert out["port"] == out["ref"]


def test_retry_budget_exhaustion_is_typed_and_bounded(pair):
    ref_model, model = pair
    out = {}
    for side, eng, mod in (
            ("port", _engine(model, max_len=64, slots=1, buckets=[16],
                             max_retries=1), faults),
            ("ref", RefEngine(ref_model, max_len=64, slots=1, buckets=[16],
                              max_retries=1), ref_faults)):
        plane = mod.FaultPlane([mod.FaultSpec(
            "pool.step", error=mod.TransientInjectedFault, times=10)])
        with mod.injected(plane):
            a = eng.submit(np.zeros(4, np.int32), 4)
            _pump_bounded(eng, 50)
        st = a.result(timeout_s=0)
        snap = eng.metrics.snapshot()
        out[side] = (st.state, st.error,
                     snap["serving_requests_failed_total"],
                     snap["serving_requests_recovered_total"],
                     plane.hits)
    state, error, failed, recovered, _ = out["port"]
    assert state == RequestState.FAILED
    assert "retry budget exhausted" in error and "retries=1/1" in error
    assert failed == 1 and recovered == 1
    assert out["port"] == out["ref"]


# -- deadline-aware load shedding ----------------------------------------------------
def test_unattainable_deadline_shed_at_admission(pair):
    ref_model, model = pair
    out = {}
    for side, eng in (("port", _engine(model, max_len=128, slots=1,
                                       buckets=[16])),
                      ("ref", RefEngine(ref_model, max_len=128, slots=1,
                                        buckets=[16]))):
        # before any observed tick there is no rate: never shed on a guess
        warm = eng.submit(np.zeros(4, np.int32), 3, deadline_s=1e-9)
        while eng.pump(8):
            pass
        busy = eng.submit(np.zeros(4, np.int32), 100)
        eng.pump(2)
        assert eng.request_state(busy.request_id) == RequestState.DECODING
        with pytest.raises(Exception) as ei:
            eng.submit(np.zeros(4, np.int32), 20, deadline_s=1e-9)
        assert type(ei.value).__name__ == "DeadlineUnattainableError"
        assert ei.value.retry_after_s > 0 and "shed" in str(ei.value)
        ok = eng.submit(np.zeros(4, np.int32), 5, deadline_s=1e6)
        while eng.pump(200):
            pass
        out[side] = (warm.result(timeout_s=0).state,
                     eng.metrics.snapshot()["serving_requests_shed_total"],
                     ok.result(timeout_s=0).state,
                     busy.result(timeout_s=0).state)
    assert isinstance(ei.value, Exception)
    assert out["port"] == out["ref"] == (RequestState.EXPIRED, 1,
                                         RequestState.DONE,
                                         RequestState.DONE)
    assert issubclass(DeadlineUnattainableError, Exception)


def test_drain_timeout_honored_in_pump_mode(model):
    eng = _engine(model, max_len=64, slots=1, buckets=[16])
    s = eng.submit(np.zeros(5, np.int32), 40)
    eng.pump(1)
    assert eng.drain(timeout_s=0.0) is False
    assert eng.draining
    with pytest.raises(PreconditionNotMetError):
        eng.submit(np.zeros(4, np.int32), 2)
    assert eng.drain() is True
    assert s.result(timeout_s=0).state == RequestState.DONE
    assert s.result(timeout_s=0).new_tokens == 40


# -- supervision ----------------------------------------------------------------------
def test_supervisor_stall_detection_and_healthz_state(pair):
    from paddle_tpu.serving import Supervisor as RefSupervisor

    ref_model, model = pair
    out = {}
    for side, make, sup_cls in (
            ("port", lambda c: _engine(model, max_len=32, slots=1,
                                       buckets=[8], clock=c), Supervisor),
            ("ref", lambda c: RefEngine(ref_model, max_len=32, slots=1,
                                        buckets=[8], clock=c),
             RefSupervisor)):
        clock = FakeClock()
        eng = make(clock)
        sup = sup_cls(eng, stall_timeout_s=0.5, clock=clock)
        trail = [eng.health()["state"]]
        eng._health.note_tick_start(clock())
        clock.advance(0.4)
        trail.append(sup.check_once())
        clock.advance(0.2)
        trail.append(sup.check_once())
        trail.append(sup.check_once())
        h = eng.health()
        trail += [h["state"], h["healthy"], h["ticks_stalled"],
                  eng.metrics.snapshot()["serving_ticks_stalled_total"]]
        eng._health.note_tick_end(clock())
        h = eng.health()
        trail += [h["healthy"], h["ticks_stalled"]]
        out[side] = trail
    assert out["port"] == ["idle", [], ["stall-detected"], [], "wedged",
                           False, 1, 1, True, 1]
    assert out["port"] == out["ref"]


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_supervisor_restarts_dead_loop(model):
    # the SystemExit that kills the loop IS the scenario under test
    eng = _engine(model, max_len=32, slots=1, buckets=[8])
    sup = Supervisor(eng, stall_timeout_s=5.0)
    assert eng.restart_loop() is False
    eng.start()
    try:
        t_old = eng._thread

        def boom():
            raise SystemExit

        eng._tick = boom
        t_old.join(timeout=10.0)
        assert not t_old.is_alive()
        del eng._tick
        h = eng.health()
        assert h["state"] == "loop-dead" and not h["healthy"]
        assert sup.check_once() == ["loop-restarted"]
        assert eng._thread is not t_old and eng._thread.is_alive()
        assert eng.restart_loop() is False
        h = eng.health()
        assert h["restarts"] == 1 and h["healthy"]
        assert eng.metrics.snapshot()["serving_engine_restarts_total"] == 1
        # the restarted loop serves
        st = eng.submit(np.arange(1, 5), 3).result(timeout_s=60.0)
        assert st is not None and st.state == RequestState.DONE
    finally:
        eng.shutdown()
    assert eng.restart_loop() is False


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_drain_returns_on_a_dead_loop(model):
    """A draining engine is never restarted, so with its loop dead nothing
    would finish the live requests: drain (and shutdown) return instead of
    waiting for ever."""
    eng = _engine(model, max_len=32, slots=1, buckets=[8])
    eng.start()
    t_old = eng._thread

    def boom():
        raise SystemExit

    eng._tick = boom
    t_old.join(timeout=10.0)
    assert not t_old.is_alive()
    del eng._tick
    s = eng.submit(np.arange(1, 5), 3)
    t0 = time.monotonic()
    assert eng.drain() is False
    assert eng.restart_loop() is False  # draining: never restarted
    eng.shutdown()
    assert time.monotonic() - t0 < 30.0
    assert s.result(timeout_s=0) is None  # nothing served it
    assert eng.health()["state"] == "draining"


def test_loop_records_error_into_health(model):
    clock_before = time.monotonic()
    eng = _engine(model, max_len=32, slots=1, buckets=[8])
    eng.start()
    try:
        def boom():
            raise RuntimeError("post-mortem me")

        eng._tick = boom
        deadline = time.monotonic() + 10.0
        while eng.health()["last_error"] is None \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        del eng._tick
        h = eng.health()
        assert h["last_error"] == "RuntimeError: post-mortem me"
        assert h["last_error_kind"] == "loop"
        assert h["last_error_at"] is not None
        assert h["last_error_at"] >= clock_before
        assert h["loop_alive"] is True
    finally:
        eng.shutdown()


def test_failed_reset_fails_survivors_and_the_loop_lives_on(model):
    """A reset that raises (a sticky device error on the card) takes the
    "pool rebuild failed" path: the survivors end FAILED, the error
    reaches the loop, which records it and keeps serving."""
    eng = _engine(model, max_len=64, slots=2, buckets=[16], max_retries=3)
    real_reset = eng._pool.reset
    calls = []

    def sticky_reset():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("CUDA error: an illegal memory access")
        real_reset()

    eng._pool.reset = sticky_reset
    eng.start()
    try:
        plane = FaultPlane([FaultSpec("pool.step",
                                      error=TransientInjectedFault,
                                      after=1, times=1)])
        with faults.injected(plane):
            a = eng.submit(np.arange(1, 6), 8)
            st = a.result(timeout_s=60.0)
        assert st is not None and st.state == RequestState.FAILED
        assert "pool rebuild failed" in st.error
        assert "illegal memory access" in st.error
        deadline = time.monotonic() + 10.0
        while eng.health()["last_error_kind"] != "loop" \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        assert eng.health()["last_error_kind"] == "loop"
        assert eng.health()["loop_alive"] is True
        # the next request is served after a good reset
        b = eng.submit(np.arange(1, 6), 3).result(timeout_s=60.0)
        assert b is not None and b.state == RequestState.DONE
    finally:
        eng.shutdown()


# -- the seeded chaos harness (tests/test_chaos_serving.py) -------------------------
CHAOS_POINTS = ("pool.step", "pool.alloc_blocks", "stream.deliver")
MAX_FAULTS = 6
MAX_RETRIES = 8
CHAOS = dict(PAGED, max_retries=MAX_RETRIES)


def _traffic(seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (n,)).astype("int32")
            for n in (5, 9, 7, 4)], (6, 5, 7, 4)


def _drive(eng, prompts, budgets):
    streams = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
    _pump_bounded(eng)
    return streams


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_chaos_invariants_hold(model, refs, seed):
    prompts, budgets = _traffic(seed)
    clean = _engine(model, **CHAOS)
    baseline = clean.cache_stats()
    want = [s.result(timeout_s=0).tokens
            for s in _drive(clean, prompts, budgets)]
    eng = _engine(model, **CHAOS)
    plane = FaultPlane(chaos_seed=seed, chaos_p=0.08,
                       chaos_points=CHAOS_POINTS, max_faults=MAX_FAULTS)
    with faults.injected(plane):
        streams = _drive(eng, prompts, budgets)
    rplane = ref_faults.FaultPlane(chaos_seed=seed, chaos_p=0.08,
                                   chaos_points=CHAOS_POINTS,
                                   max_faults=MAX_FAULTS)
    ref = refs.run(prompts, budgets, plane=rplane, **CHAOS)
    # the same seed injected at the same hits in both packages
    assert plane.injected == rplane.injected
    statuses = [s.result(timeout_s=0) for s in streams]
    for p, st, w, r in zip(prompts, statuses, want, ref):
        assert st.state == RequestState.DONE, (seed, st.state, st.error)
        np.testing.assert_array_equal(st.tokens, w)
        assert_greedy_equal(model, p, st.tokens, r.tokens, seed)
    stats = eng.cache_stats()
    assert stats["mapped_blocks"] == 0
    assert stats["free_blocks"] == baseline["free_blocks"]
    assert eng.live_requests == 0 and eng.queue_depth == 0
    snap = eng.metrics.snapshot()
    assert snap["serving_requests_submitted_total"] == len(prompts)
    assert snap["serving_requests_completed_total"] == len(prompts)
    assert snap["serving_requests_failed_total"] == 0
    assert snap["serving_tokens_emitted_total"] == \
        sum(st.new_tokens for st in statuses) == sum(len(w) for w in want)
    rsnap = refs.last_engine.metrics.snapshot()
    for name in ("serving_recoveries_total",
                 "serving_requests_recovered_total"):
        assert snap[name] == rsnap[name], name
    if any(rec[2] == "TransientInjectedFault" for rec in plane.injected):
        assert snap["serving_recoveries_total"] >= 1
        assert snap["serving_requests_recovered_total"] >= 1
        assert eng.health()["last_error"] is not None
    assert eng.compile_counts() == clean.compile_counts()


def _bursty_schedule(seed):
    """ON/OFF phases of low-priority bursts with sporadic high-priority
    arrivals: ``[(tick, rid, prompt, budget, priority), ...]``."""
    rng = np.random.RandomState(1000 + seed)
    plan, rid, tick = [], 0, 0
    for _ in range(3):
        on_len = 2 + rng.randint(2)
        for t in range(on_len):
            for _ in range(1 + rng.randint(2)):
                plan.append((tick + t, "b%d" % rid,
                             rng.randint(0, 128, (4 + rng.randint(6),))
                             .astype("int32"), 3 + rng.randint(4), -1))
                rid += 1
        if rng.rand() < 0.8:
            plan.append((tick + rng.randint(on_len), "h%d" % rid,
                         rng.randint(0, 128, (5,)).astype("int32"),
                         3 + rng.randint(3), 1))
            rid += 1
        tick += on_len + 2 + rng.randint(3)
    return plan


def _drive_bursty(eng, plan, preempt_every=None):
    streams = {}
    horizon = max(t for t, *_ in plan)
    tick, work = 0, True
    while work or tick <= horizon:
        for (t, rid, prompt, budget, prio) in plan:
            if t == tick:
                streams[rid] = eng.submit(prompt, budget, request_id=rid,
                                          priority=prio)
        if preempt_every and tick and tick % preempt_every == 0:
            eng.preempt()
        work = eng.pump(1)
        tick += 1
        assert tick < 700, "bursty chaos run failed to drain: wedged"
        stats = eng.cache_stats()
        assert stats["free_blocks"] + stats["mapped_blocks"] \
            + stats["spilled_blocks"] + 1 == stats["num_blocks"]
    return streams


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_bursty_chaos_with_preemption(pair, refs, seed):
    ref_model, model = pair
    plan = _bursty_schedule(seed)
    clean = _engine(model, **CHAOS)
    baseline = clean.cache_stats()
    want = {rid: s.result(timeout_s=0).tokens
            for rid, s in _drive_bursty(clean, plan).items()}
    eng = _engine(model, **CHAOS)
    plane = FaultPlane(chaos_seed=seed, chaos_p=0.05,
                       chaos_points=CHAOS_POINTS, max_faults=MAX_FAULTS)
    with faults.injected(plane):
        streams = _drive_bursty(eng, plan, preempt_every=3)
    # the reference under the same plan, plane seed and preempt cadence
    ref_eng = refs.engine(**CHAOS)
    rplane = ref_faults.FaultPlane(chaos_seed=seed, chaos_p=0.05,
                                   chaos_points=CHAOS_POINTS,
                                   max_faults=MAX_FAULTS)
    with ref_faults.injected(rplane):
        ref_streams = _drive_bursty(ref_eng, plan, preempt_every=3)
    assert plane.injected == rplane.injected
    prompts = {rid: p for _, rid, p, _, _ in plan}
    for rid, s in streams.items():
        st = s.result(timeout_s=0)
        assert st.state == RequestState.DONE, (seed, rid, st.state,
                                               st.error)
        np.testing.assert_array_equal(st.tokens, want[rid])
        assert_greedy_equal(model, prompts[rid], st.tokens,
                            ref_streams[rid].result(timeout_s=0).tokens,
                            rid)
    stats = eng.cache_stats()
    assert stats["mapped_blocks"] == 0 and stats["spilled_blocks"] == 0
    assert stats["free_blocks"] == baseline["free_blocks"]
    assert eng.live_requests == 0 and eng.queue_depth == 0
    snap = eng.metrics.snapshot()
    rsnap = ref_eng.metrics.snapshot()
    assert snap["serving_requests_submitted_total"] == len(plan)
    assert snap["serving_requests_completed_total"] == len(plan)
    assert snap["serving_requests_failed_total"] == 0
    assert snap["serving_tokens_emitted_total"] == \
        sum(len(w) for w in want.values())
    assert snap["serving_preemptions_total"] >= snap["serving_resumes_total"]
    for name in ("serving_preemptions_total", "serving_resumes_total",
                 "serving_recoveries_total"):
        assert snap[name] == rsnap[name], name
    assert eng.spill_stats()["spilled_requests"] == 0
    assert eng.compile_counts() == clean.compile_counts()


def test_bursty_sweep_actually_preempts_and_resumes(model):
    preempts = resumes = 0
    for seed in (0, 1, 2, 3, 4):
        eng = _engine(model, **CHAOS)
        _drive_bursty(eng, _bursty_schedule(seed), preempt_every=3)
        snap = eng.metrics.snapshot()
        preempts += snap["serving_preemptions_total"]
        resumes += snap["serving_resumes_total"]
    assert preempts >= 1 and resumes >= 1


def test_chaos_across_seeds_actually_injects(model):
    fired = 0
    for seed in (0, 1, 2, 3, 4):
        prompts, budgets = _traffic(seed)
        eng = _engine(model, **CHAOS)
        plane = FaultPlane(chaos_seed=seed, chaos_p=0.08,
                           chaos_points=CHAOS_POINTS,
                           max_faults=MAX_FAULTS)
        with faults.injected(plane):
            _drive(eng, prompts, budgets)
        fired += plane.fault_count
    assert fired >= 1
