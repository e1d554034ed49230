"""The port's serving engine -- lifecycle, streaming, deadlines, metrics,
the automatic victim, the degradation ladder, recovery of preempted
requests, the deadline-shed estimate and SLOs -- re-pointed from the
reference's ``tests/test_serving.py``, the ladder/victim/recovery/estimate
tests of ``tests/test_scheduling.py`` and the SLO tests of
``tests/test_observatory.py``, and held against the reference's engine on
the same weights (CPU).

Greedy tokens are compared with the reference's run of the same traffic
(``torch_parity.assert_greedy_equal``: equal unless the top-2 margin is
under the floor); metric names, health fields and SLO snapshot fields are
compared with the reference engine's.  The port has no cost report yet:
its metric names are the only ones the reference has and the port
lacks.
"""
import io
import json
import threading
import time

import numpy as np
import pytest

from paddle_tpu.serving import ServingEngine as RefEngine
from paddle_tpu.serving import SLOTracker as RefSLOTracker
from paddle_tpu.serving import Objective as RefObjective
from torch_parity import (SMALL, FakeClock, RefEngines, assert_greedy_equal,
                          build_pair)

from paddle_tpu_torch import DecodeSession, GenerationPool
from paddle_tpu_torch.core.errors import (InvalidArgumentError,
                                          NotFoundError,
                                          PreconditionNotMetError,
                                          UnavailableError)
from paddle_tpu_torch.inference.generation import DuplicateRequestError
from paddle_tpu_torch.jit.decode import (FINISH_EOS, FINISH_LENGTH,
                                         classify_finish)
from paddle_tpu_torch.serving import (AdmissionTightenedError, Histogram,
                                      MetricsRegistry, Objective,
                                      QueueFullError, RequestState,
                                      ServingEngine, SLOTracker, faults)
from paddle_tpu_torch.serving import log as slog

# metric names of reference features the port does not have yet (the
# cost report)
# every metric of the reference's engine is ported (the cost gauges since
# the cost attribution's port)
NOT_PORTED_METRICS = frozenset()


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


def _drain(eng, steps=8):
    while eng.pump(steps):
        pass


# -- token identity and compile counts --------------------------------------
@pytest.mark.parametrize("layout_kw", [
    pytest.param({}, id="dense"),
    pytest.param(dict(cache_layout="paged", block_size=8), id="paged"),
])
def test_streamed_greedy_token_identical_to_pool_run(model, refs,
                                                     layout_kw):
    prompts = _prompts(0, (5, 11, 7, 3))
    cfg = dict(max_len=64, slots=2, buckets=[16], **layout_kw)
    pool = GenerationPool(model, device="cpu", **cfg)
    rids = [pool.submit(p, 6) for p in prompts]
    want = pool.run()
    eng = _engine(model, **cfg)
    streams = [eng.submit(p, 6) for p in prompts]
    ref = refs.run(prompts, [6] * 4, **cfg)
    for s, rid, p, r in zip(streams, rids, prompts, ref):
        got = np.asarray(list(s), np.int32)  # iteration pumps inline
        np.testing.assert_array_equal(got, want[rid])
        st = s.result(timeout_s=0)
        assert st.state == RequestState.DONE == r.state
        assert st.finish_reason == FINISH_LENGTH == r.finish_reason
        assert st.new_tokens == 6 and st.prompt_tokens == len(p)
        np.testing.assert_array_equal(st.tokens, want[rid])
        assert st.ttft_s is not None and st.total_s >= st.ttft_s >= 0
        assert_greedy_equal(model, p, st.tokens, r.tokens)
    counts = eng.compile_counts()
    assert counts["prefill"] == 1
    assert counts["pool_decode"] == 1 and counts["slot_insert"] == 1


# -- deadlines -----------------------------------------------------------------
def _deadline_run(make):
    """The reference test's two expiry paths on ONE slot: ``b`` (tighter
    deadline, submitted second) takes the slot and expires mid-decode,
    ``a`` waits, then decodes and expires too."""
    clock = FakeClock()
    eng = make(clock)
    baseline = eng.cache_stats()
    a = eng.submit(np.zeros(5, np.int32), 40, deadline_s=1.0)
    b = eng.submit(np.zeros(7, np.int32), 20, deadline_s=0.5)
    eng.pump(3)
    states = [eng.request_state(b.request_id),
              eng.request_state(a.request_id)]
    mapped = eng.cache_stats()["mapped_blocks"]
    clock.advance(0.6)
    eng.pump(2)
    states.append(eng.request_state(a.request_id))
    clock.advance(0.5)
    more = eng.pump(1)
    return dict(eng=eng, a=a.result(timeout_s=0), b=b.result(timeout_s=0),
                states=states, mapped=mapped, more=more,
                baseline=baseline, stats=eng.cache_stats(),
                snap=eng.metrics.snapshot())


def test_deadline_expiry_frees_slot_and_blocks(pair):
    ref_model, model = pair
    cfg = dict(max_len=64, slots=1, buckets=[16], cache_layout="paged",
               block_size=8)
    got = _deadline_run(lambda c: _engine(model, clock=c, **cfg))
    want = _deadline_run(lambda c: RefEngine(ref_model, clock=c, **cfg))
    assert got["states"] == want["states"] == [
        RequestState.DECODING, RequestState.QUEUED, RequestState.DECODING]
    assert got["mapped"] > 0 and got["more"] is False
    for k in ("a", "b"):
        st, rst = got[k], want[k]
        assert st.state == rst.state == RequestState.EXPIRED
        assert st.finish_reason == rst.finish_reason == "deadline"
        assert st.new_tokens == rst.new_tokens
        assert 0 < st.new_tokens < (40 if k == "a" else 20)
    stats = got["stats"]
    assert stats["mapped_blocks"] == 0
    assert stats["free_blocks"] == got["baseline"]["free_blocks"]
    for name in ("serving_requests_expired_total",):
        assert got["snap"][name] == want["snap"][name] == 2
    assert got["snap"]["serving_ttft_seconds"]["count"] == \
        want["snap"]["serving_ttft_seconds"]["count"] == 2


def test_submit_rejects_nonpositive_deadline(pair):
    ref_model, model = pair
    for eng, err in ((_engine(model, max_len=32, slots=1, buckets=[8]),
                      InvalidArgumentError),
                     (RefEngine(ref_model, max_len=32, slots=1,
                                buckets=[8]), Exception)):
        for bad in (0.0, -1.0, float("nan")):
            with pytest.raises(err, match="deadline_s"):
                eng.submit(np.zeros(4, np.int32), 2, deadline_s=bad)


# -- admission control -------------------------------------------------------
def test_queue_full_fails_fast_and_counts(pair):
    ref_model, model = pair
    cfg = dict(max_len=64, slots=1, buckets=[16], max_queue=2)
    eng = _engine(model, **cfg)
    ref = RefEngine(ref_model, **cfg)
    for e in (eng, ref):
        streams = [e.submit(np.zeros(4, np.int32), 4) for _ in range(2)]
        with pytest.raises(Exception, match="max_queue") as ei:
            e.submit(np.zeros(4, np.int32), 4)
        assert type(ei.value).__name__ == "QueueFullError"
        assert e.metrics.snapshot()["serving_admission_rejected_total"] == 1
        if e is eng:
            assert isinstance(ei.value, QueueFullError)
            _drain(e, 16)
            assert all(s.result(timeout_s=0).state == RequestState.DONE
                       for s in streams)
            e.submit(np.zeros(4, np.int32), 2)  # admission open again


def test_duplicate_request_id_typed_error_names_id(pair):
    ref_model, model = pair
    for e in (_engine(model, max_len=32, slots=1, buckets=[8]),
              RefEngine(ref_model, max_len=32, slots=1, buckets=[8])):
        e.submit(np.zeros(4, np.int32), 2, request_id="job-17")
        with pytest.raises(Exception, match="job-17") as ei:
            e.submit(np.zeros(4, np.int32), 2, request_id="job-17")
        assert type(ei.value).__name__ == "DuplicateRequestError"
        assert e.live_requests == 1
    assert issubclass(DuplicateRequestError, InvalidArgumentError)


# -- cancellation ---------------------------------------------------------------
def test_cancel_mid_decode_frees_blocks_without_corrupting_survivor(pair):
    ref_model, model = pair
    pa, pb = _prompts(3, (5, 9))
    cfg = dict(max_len=64, slots=2, buckets=[16], cache_layout="paged",
               block_size=8)
    out = {}
    for side, e in (("port", _engine(model, **cfg)),
                    ("ref", RefEngine(ref_model, **cfg))):
        free0 = e.cache_stats()["free_blocks"]
        a = e.submit(pa, 30)
        b = e.submit(pb, 6)
        e.pump(2)
        assert e.cancel(a.request_id) is True
        assert e.cancel(a.request_id) is False
        st = a.result(timeout_s=0)
        assert st.state == RequestState.CANCELLED
        assert st.finish_reason == "cancelled" and 0 < st.new_tokens < 30
        _drain(e)
        assert e.cache_stats()["free_blocks"] == free0
        snap = e.metrics.snapshot()
        assert snap["serving_requests_cancelled_total"] == 1
        assert snap["serving_requests_completed_total"] == 1
        c = e.submit(np.zeros(4, np.int32), 30)
        e.pump(1)
        e.shutdown(drain=False)
        assert c.result(timeout_s=0).state == RequestState.CANCELLED
        assert e.cache_stats()["free_blocks"] == free0
        out[side] = (st.new_tokens, b.result(timeout_s=0).tokens)
    sess = DecodeSession(model, max_len=64, buckets=[16], device="cpu")
    np.testing.assert_array_equal(out["port"][1],
                                  sess.generate(pb[None], 6)[0])
    assert out["port"][0] == out["ref"][0]
    assert_greedy_equal(model, pb, out["port"][1], out["ref"][1])


def test_pool_release_and_cancel_surface(model):
    pool = GenerationPool(model, max_len=64, slots=2, buckets=[16],
                          cache_layout="paged", block_size=8, device="cpu")
    free0 = len(pool._free_blocks)
    ra = pool.submit(np.zeros(5, np.int32), 20)
    rb = pool.submit(np.zeros(6, np.int32), 4)
    pool.step()
    assert pool.active_count == 2
    assert pool.cancel(ra) == "active"
    assert pool.active_count == 1
    rc = pool.submit(np.zeros(4, np.int32), 3)
    assert pool.cancel(rc) == "queued"
    with pytest.raises(NotFoundError):
        pool.cancel("nope")
    assert set(pool.run()) == {rb}
    assert len(pool._free_blocks) == free0
    with pytest.raises(NotFoundError):
        pool.collect(rb)


# -- drain / shutdown / weight refresh ------------------------------------------
def test_drain_stops_admissions_and_finishes_inflight(model, refs):
    eng = _engine(model, max_len=64, slots=2, buckets=[16])
    s = eng.submit(np.zeros(5, np.int32), 4)
    assert eng.drain() is True
    st = s.result(timeout_s=0)
    assert st.state == RequestState.DONE
    ref = refs.run([np.zeros(5, np.int32)], [4], max_len=64, slots=2,
                   buckets=[16])[0]
    assert_greedy_equal(model, np.zeros(5, np.int32), st.tokens, ref.tokens)
    assert eng.draining
    with pytest.raises(PreconditionNotMetError, match="drain"):
        eng.submit(np.zeros(4, np.int32), 2)
    # the refresh seam fires the plane (the steps read weights by
    # address, so it has nothing else to drop)
    plane = faults.FaultPlane([faults.FaultSpec(
        "weights.refresh", error=faults.TransientInjectedFault)])
    with faults.injected(plane):
        with pytest.raises(faults.TransientInjectedFault):
            eng.refresh_weights()
    eng.refresh_weights()
    assert plane.hits == {"weights.refresh": 1}


# -- finish reasons ----------------------------------------------------------------
def test_eos_finish_reason_threads_through(pair):
    ref_model, model = pair
    p = _prompts(5, (6,))[0]
    toks = DecodeSession(model, max_len=64, buckets=[16],
                         device="cpu").generate(p[None], 6)[0]
    eos = int(toks[2])
    cfg = dict(max_len=64, slots=1, buckets=[16], eos_id=eos)
    st = _engine(model, **cfg).submit(p, 6).result()
    rst = RefEngine(ref_model, **cfg).submit(p, 6).result()
    assert st.state == rst.state == RequestState.DONE
    assert st.finish_reason == rst.finish_reason == FINISH_EOS
    assert int(st.tokens[-1]) == eos and st.new_tokens <= 3
    assert_greedy_equal(model, p, st.tokens, rst.tokens)


def test_classify_finish_vocabulary():
    from paddle_tpu.jit.decode import classify_finish as ref_classify

    for toks, eos in (([4, 7, 2], 2), ([4, 7, 2], 9), ([4, 7, 2], None),
                      ([], 2)):
        assert classify_finish(toks, eos_id=eos) == ref_classify(
            toks, eos_id=eos)
    assert classify_finish([4, 7, 2], eos_id=2) == FINISH_EOS
    assert classify_finish([], eos_id=2) == FINISH_LENGTH


# -- metrics ------------------------------------------------------------------------
def test_metrics_snapshot_and_prometheus_render(model, refs):
    reg = MetricsRegistry()
    eng = _engine(model, max_len=64, slots=2, buckets=[16], metrics=reg)
    prompts = [np.zeros(n, np.int32) for n in (4, 6)]
    streams = [eng.submit(p, 4) for p in prompts]
    _drain(eng)
    assert all(s.result(timeout_s=0).state == RequestState.DONE
               for s in streams)
    ref = refs.engine(max_len=64, slots=2, buckets=[16])
    snap = eng.metrics.snapshot()
    ref_streams = [ref.submit(p, 4) for p in prompts]
    _drain(ref)
    assert all(s.result(timeout_s=0).state == "DONE" for s in ref_streams)
    rsnap = ref.metrics.snapshot()
    # the reference's names, minus the features not ported
    assert set(snap) == set(rsnap) - NOT_PORTED_METRICS
    for name in ("serving_requests_submitted_total",
                 "serving_requests_completed_total",
                 "serving_tokens_emitted_total", "serving_queue_depth"):
        assert snap[name] == rsnap[name], name
    assert snap["serving_requests_submitted_total"] == 2
    assert snap["serving_tokens_emitted_total"] == 8
    for name in ("serving_ttft_seconds", "serving_inter_token_seconds"):
        assert snap[name]["count"] == rsnap[name]["count"], name
    assert snap["serving_inter_token_seconds"]["count"] == 6
    assert snap["serving_queue_depth_per_step"]["count"] >= 1
    assert snap["serving_tokens_per_sec"] > 0
    text = eng.metrics.render_prometheus()
    assert "# TYPE serving_ttft_seconds histogram" in text
    assert 'serving_ttft_seconds_bucket{le="+Inf"} 2' in text
    assert "serving_ttft_seconds_count 2" in text
    assert "# TYPE serving_requests_completed_total counter" in text
    assert "serving_requests_completed_total 2" in text
    assert "# TYPE serving_queue_depth gauge" in text
    # a second engine over the same registry accumulates
    eng2 = _engine(model, max_len=32, slots=1, buckets=[8], metrics=reg)
    eng2.submit(np.zeros(4, np.int32), 2)
    _drain(eng2, 4)
    assert reg.snapshot()["serving_requests_completed_total"] == 3


def test_kv_resident_bytes_gauge_dtype_aware(pair):
    ref_model, model = pair
    resident = {}
    for dtype in ("float32", "int8"):
        cfg = dict(max_len=64, slots=2, buckets=[16], cache_dtype=dtype)
        eng = _engine(model, **cfg)
        eng.submit(np.zeros(5, np.int32), 3)
        _drain(eng)
        snap = eng.metrics.snapshot()
        assert snap["serving_kv_resident_bytes"] == \
            eng.cache_stats()["pool_bytes"]
        resident[dtype] = snap["serving_kv_resident_bytes"]
        # no step needed: the reference's allocation is the same size
        ref = RefEngine(ref_model, **cfg)
        assert resident[dtype] == ref.cache_stats()["pool_bytes"]
    assert 0 < resident["int8"] <= 0.55 * resident["float32"]
    cfg = dict(max_len=64, slots=2, buckets=[16], cache_layout="paged",
               block_size=8, num_blocks=5, cache_dtype="int8")
    paged = _engine(model, **cfg)
    paged.submit(np.zeros(5, np.int32), 3)
    _drain(paged)
    snap = paged.metrics.snapshot()
    assert snap["serving_kv_resident_bytes"] == \
        paged.cache_stats()["pool_bytes"] == \
        RefEngine(ref_model, **cfg).cache_stats()["pool_bytes"]
    assert snap["serving_kv_resident_bytes"] < resident["int8"]


def test_metrics_registry_typing_and_quantile():
    from paddle_tpu.serving import Histogram as RefHistogram

    reg = MetricsRegistry()
    c = reg.counter("x_total", "help")
    assert reg.counter("x_total") is c
    with pytest.raises(InvalidArgumentError, match="x_total"):
        reg.gauge("x_total")
    hh = reg.histogram("h_hist", buckets=(0.1, 1.0))
    assert reg.histogram("h_hist", buckets=(0.1, 1.0)) is hh
    with pytest.raises(InvalidArgumentError, match="buckets"):
        reg.histogram("h_hist", buckets=(0.1, 2.0))
    with pytest.raises(InvalidArgumentError):
        reg.counter("bad name")
    with pytest.raises(InvalidArgumentError):
        c.inc(-1)
    h = Histogram("h", buckets=(0.1, 1.0, 10.0))
    rh = RefHistogram("h", buckets=(0.1, 1.0, 10.0))
    assert h.quantile(0.5) is None
    for v in (0.05, 0.5, 0.5, 5.0, 100.0):
        h.observe(v)
        rh.observe(v)
        for q in (0.0, 0.5, 1.0):
            assert h.quantile(q) == rh.quantile(q)
    assert h.quantile(1.0) == float("inf")
    assert h.snapshot() == rh.snapshot()
    h.reset()
    assert h.quantile(0.5) is None and h.count == 0 and h.sum == 0.0
    h.observe(0.5)
    assert h.quantile(1.0) == 1.0


# -- the two drive modes share one code path ------------------------------------
def test_pump_refused_while_thread_owns_engine(model):
    eng = _engine(model, max_len=32, slots=1, buckets=[8])
    eng.start()
    try:
        with pytest.raises(PreconditionNotMetError, match="pump"):
            eng.pump(1)
    finally:
        eng.shutdown()


def test_background_thread_mode_token_identical(model, refs):
    prompts = _prompts(9, (5, 11, 7))
    cfg = dict(max_len=64, slots=2, buckets=[16])
    ref = refs.run(prompts, [6] * 3, **cfg)
    eng = _engine(model, **cfg).start()
    try:
        # submitted from several threads while the loop runs
        streams = [None] * len(prompts)

        def submit(i):
            streams[i] = eng.submit(prompts[i], 6)

        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
        statuses = [s.result(timeout_s=120.0) for s in streams]
    finally:
        eng.shutdown()
    for p, st, r in zip(prompts, statuses, ref):
        assert st is not None and st.state == RequestState.DONE
        assert_greedy_equal(model, p, st.tokens, r.tokens)
    assert eng.health()["state"] == "stopped"


def test_engine_lock_hands_over_in_arrival_order():
    """The loop releases the engine lock and takes it again at once: a
    thread already waiting must get it first (CPython's own locks let the
    releasing thread win that race)."""
    from paddle_tpu_torch.serving.engine import _FairRLock

    lock = _FairRLock()
    order = []
    lock.acquire()
    lock.acquire()  # reentrant

    def waiter():
        with lock:
            order.append("waiter")

    t = threading.Thread(target=waiter)
    t.start()
    deadline = time.monotonic() + 30.0
    while not lock._queue and time.monotonic() < deadline:
        time.sleep(0.001)
    assert list(lock._queue), "the waiter never queued"
    lock.release()
    lock.release()
    with lock:  # the releasing thread queues behind the waiter
        order.append("owner")
    t.join(timeout=30.0)
    assert not t.is_alive()
    assert order == ["waiter", "owner"]
    with pytest.raises(RuntimeError):
        lock.release()


def test_loop_stress_threads_submit_and_cancel(model):
    """More client threads than cores submit, cancel and read stats
    against the running loop with a short switch interval: every request
    reaches a terminal state, the counters reconcile and the allocator
    partition is exact at the end (a lost update would break one)."""
    import os
    import sys

    eng = _engine(model, max_len=64, slots=2, buckets=[16],
                  cache_layout="paged", block_size=8, max_queue=256)
    n_threads = 2 * (os.cpu_count() or 2) + 2
    streams, errors = [], []
    guard = threading.Lock()

    def client(i):
        try:
            rng = np.random.RandomState(i)
            for j in range(3):
                s = eng.submit(rng.randint(0, 128, (4 + j,)), 3 + j,
                               request_id="c%d-%d" % (i, j))
                with guard:
                    streams.append(s)
                if (i + j) % 3 == 0:
                    eng.cancel(s.request_id)
                eng.cache_stats()
                eng.health()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    eng.start()
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        assert not any(t.is_alive() for t in threads)
        statuses = [s.result(timeout_s=120.0) for s in streams]
    finally:
        sys.setswitchinterval(old)
        eng.shutdown()
    assert not errors, errors
    assert all(st is not None for st in statuses)
    states = [st.state for st in statuses]
    assert set(states) <= {RequestState.DONE, RequestState.CANCELLED}
    snap = eng.metrics.snapshot()
    assert snap["serving_requests_submitted_total"] == len(streams)
    assert snap["serving_requests_completed_total"] \
        + snap["serving_requests_cancelled_total"] == len(streams)
    assert snap["serving_tokens_emitted_total"] == \
        sum(st.new_tokens for st in statuses)
    stats = eng.cache_stats()
    assert stats["mapped_blocks"] == 0
    assert stats["free_blocks"] + 1 == stats["num_blocks"]
    assert eng.live_requests == 0 and eng.queue_depth == 0


# -- the automatic victim (tests/test_scheduling.py) --------------------------
_VICTIM_SUBS = [("hi", 10, 1), ("old-low", 11, -1), ("new-low", 12, -1)]


def _auto_victim(e):
    streams = {rid: e.submit(_prompts(seed, (5,))[0], 12, request_id=rid,
                             priority=prio)
               for rid, seed, prio in _VICTIM_SUBS}
    e.pump(2)
    victim = e.preempt()
    state = e.request_state("new-low")
    ms = e.metrics.snapshot()
    _drain(e, 16)
    return victim, state, ms, streams, e.metrics.snapshot()


def test_engine_auto_victim_is_lowest_priority_youngest(pair):
    ref_model, model = pair
    cfg = dict(max_len=64, slots=3, buckets=[32], cache_layout="paged",
               block_size=8)
    got = _auto_victim(_engine(model, **cfg))
    want = _auto_victim(RefEngine(ref_model, **cfg))
    assert got[0] == want[0] == "new-low"
    assert got[1] == want[1] == RequestState.PREEMPTED
    assert got[2]["serving_preemptions_total"] == 1
    assert got[2]["serving_spill_bytes_total"] == \
        want[2]["serving_spill_bytes_total"] > 0
    for rid, seed, _ in _VICTIM_SUBS:
        st = got[3][rid].result(timeout_s=0)
        assert st.state == RequestState.DONE
        assert_greedy_equal(model, _prompts(seed, (5,))[0], st.tokens,
                            want[3][rid].result(timeout_s=0).tokens, rid)
    assert got[4]["serving_resumes_total"] == 1
    dense = _engine(model, max_len=64, slots=1, buckets=[32])
    dense.submit(np.zeros(4, np.int32), 8)
    dense.pump(2)
    assert dense.preempt() is None  # nothing preemptable on a dense pool


# -- the degradation ladder ----------------------------------------------------------
def _ladder(make, objective_cls, tracker_cls, clock, **over):
    slo = tracker_cls([objective_cls("ttft_p95", "ttft", 0.5,
                                     threshold_s=0.05)],
                      fast_window=2, slow_window=4)
    kw = dict(max_len=64, slots=2, buckets=[32, 64], clock=clock,
              cache_layout="paged", block_size=8, slo=slo, degrade=True,
              degrade_dwell_ticks=1, degrade_clear_ticks=2)
    kw.update(over)
    return make(**kw)


def _ladder_run(eng, clock, log_mod):
    buf = io.StringIO()
    tracer = eng.start_trace()
    try:
        with log_mod.logging_to(buf):
            for i in range(3):
                eng.submit(_prompts(13 + i, (6,))[0], 20, priority=-1,
                           request_id="low%d" % i)
            for _ in range(3):  # every TTFT observation is bad
                clock.advance(0.2)
                eng.pump(1)
            hi = eng.submit(_prompts(20, (6,))[0], 4, priority="high",
                            request_id="hi")
            for _ in range(6):
                clock.advance(0.2)
                eng.pump(1)
            mid = (eng.slo_snapshot()["degradation"],
                   eng.metrics.snapshot(), eng.health())
            while eng.pump(8):
                clock.advance(0.001)
            for _ in range(12):
                clock.advance(0.001)
                eng.pump(1)
            end = eng.slo_snapshot()["degradation"]["level"]
    finally:
        eng.stop_trace()
    events = [json.loads(line) for line in buf.getvalue().splitlines()]
    return dict(mid=mid, end=end, hi=hi.result(timeout_s=0),
                events=events,
                rec=[e.name for e in tracer.recorder.snapshot()])


def test_ladder_steps_down_preempts_and_restores(pair):
    ref_model, model = pair
    clock = FakeClock()
    got = _ladder_run(_ladder(lambda **k: _engine(model, **k), Objective,
                              SLOTracker, clock), clock, slog)
    from paddle_tpu.serving import log as ref_slog
    rclock = FakeClock()
    want = _ladder_run(_ladder(lambda **k: RefEngine(ref_model, **k),
                               RefObjective, RefSLOTracker, rclock),
                       rclock, ref_slog)
    snap, ms, h = got["mid"]
    rsnap = want["mid"][0]
    assert snap["level"] == rsnap["level"] >= 1
    assert set(snap) == set(rsnap)  # no spec-K fields: no speculative pool
    assert ms["serving_preemptions_total"] == \
        want["mid"][1]["serving_preemptions_total"] >= 1
    assert ms["serving_degrade_level"] == snap["level"]
    assert h["healthy"] is True and h["degraded"] == snap["level"]
    assert got["end"] == want["end"] == 0
    assert got["hi"].state == RequestState.DONE
    assert_greedy_equal(model, _prompts(20, (6,))[0], got["hi"].tokens,
                        want["hi"].tokens)
    sched = [e for e in got["events"] if e["event"].startswith("sched.")]
    rsched = [e for e in want["events"] if e["event"].startswith("sched.")]
    assert [(e["event"], e.get("level"), e.get("rid")) for e in sched] == \
        [(e["event"], e.get("level"), e.get("rid")) for e in rsched]
    assert {"sched.degrade", "sched.preempt", "sched.resume",
            "sched.restore"} <= {e["event"] for e in sched}
    assert all("tick" in e for e in sched)
    assert {"sched.degrade", "sched.preempt", "sched.resume",
            "sched.restore"} <= set(got["rec"])
    restores = [e for e in sched if e["event"] == "sched.restore"]
    assert restores and restores[-1]["level"] == 0


def test_tightened_admission_sheds_below_floor_only(pair):
    ref_model, model = pair
    for make, obj, trk in ((lambda **k: _engine(model, **k), Objective,
                            SLOTracker),
                           (lambda **k: RefEngine(ref_model, **k),
                            RefObjective, RefSLOTracker)):
        eng = _ladder(make, obj, trk, FakeClock())
        eng._set_degrade_level(3, ["ttft_p95"])
        with pytest.raises(Exception, match="floor") as ei:
            eng.submit(np.zeros(4, np.int32), 2, priority=0)
        assert type(ei.value).__name__ == "AdmissionTightenedError"
        assert ei.value.retry_after_s == 1.0
        assert eng.metrics.snapshot()[
            "serving_admission_tightened_total"] == 1
        s = eng.submit(np.zeros(4, np.int32), 2, priority="high")
        _drain(eng)
        assert s.result(timeout_s=0).state == RequestState.DONE
    assert issubclass(AdmissionTightenedError, UnavailableError)


def test_degrade_requires_slo(pair):
    ref_model, model = pair
    with pytest.raises(InvalidArgumentError, match="degrade"):
        _engine(model, max_len=32, slots=1, buckets=[8], degrade=True)
    with pytest.raises(Exception, match="degrade"):
        RefEngine(ref_model, max_len=32, slots=1, buckets=[8],
                  degrade=True)
    slo = SLOTracker([Objective("a", "availability", 0.9)])
    with pytest.raises(InvalidArgumentError, match="degrade_max_level"):
        _engine(model, max_len=32, slots=1, buckets=[8], slo=slo,
                degrade=True, degrade_max_level=4)


# -- recovery x preemption ----------------------------------------------------------
def test_recovery_resubmits_preempted_victims_byte_identically(pair, refs):
    ref_model, model = pair
    p = _prompts(40, (5, 9))
    cfg = dict(max_len=64, slots=2, buckets=[32, 64], cache_layout="paged",
               block_size=8, max_retries=4)
    clean = _engine(model, **cfg)
    want = [clean.submit(ids, 8, request_id="r%d" % i)
            for i, ids in enumerate(p)]
    _drain(clean)
    want = [s.result(timeout_s=0).tokens for s in want]
    counts = clean.compile_counts()
    ref_want = refs.run(p, [8, 8], ids=["r0", "r1"], **cfg)

    eng = _engine(model, **cfg)
    streams = [eng.submit(ids, 8, request_id="r%d" % i, priority=i)
               for i, ids in enumerate(p)]
    eng.pump(2)
    eng.preempt("r0")
    plane = faults.FaultPlane([faults.FaultSpec(
        "pool.step", error=faults.TransientInjectedFault, times=1)])
    with faults.injected(plane):
        _drain(eng)
    for ids, s, w, r in zip(p, streams, want, ref_want):
        st = s.result(timeout_s=0)
        assert st.state == RequestState.DONE
        np.testing.assert_array_equal(st.tokens, w)
        assert_greedy_equal(model, ids, st.tokens, r.tokens)
    assert eng.compile_counts() == counts
    stats = eng.cache_stats()
    assert stats["mapped_blocks"] == 0 and stats["spilled_blocks"] == 0
    assert stats["free_blocks"] + stats["mapped_blocks"] \
        + stats["spilled_blocks"] + 1 == stats["num_blocks"]


# -- the deadline-shed estimate ------------------------------------------------------
def test_deadline_estimate_counts_per_request_chunk_ticks(pair):
    ref_model, model = pair
    cfg = dict(max_len=64, slots=2, cache_layout="paged", block_size=8,
               prefill_chunk_tokens=16, max_queue=64)
    out = {}
    for side, eng in (("port", _engine(model, **cfg)),
                      ("ref", RefEngine(ref_model, **cfg))):
        for i in range(10):
            eng.submit(_prompts(50 + i, (5,))[0], 2, request_id="q%d" % i)
        eng.pump(1)
        est = eng._deadline_estimate_s(2, prompt_len=5)
        step_s = eng._timer.step_time
        pending = sum(1 for rid in ("q%d" % i for i in range(10))
                      if eng.request_state(rid) in ("QUEUED", "PREFILLING"))
        assert est is not None and eng.live_requests > 0
        old_style = step_s * ((5 * pending + 5 + 15) // 16)
        assert est >= step_s * (pending + 1), (side, est, step_s, pending)
        assert est > old_style
        out[side] = (est / step_s, pending)
        _drain(eng)
    # the same tick count: the estimate's model is the reference's
    assert out["port"] == pytest.approx(out["ref"])


# -- SLOs (tests/test_observatory.py) ------------------------------------------------
def _slo_chaos(make, obj_cls, trk_cls, faults_mod):
    tracker = trk_cls([obj_cls("availability", "availability", 0.5)],
                      fast_window=3, slow_window=10)
    eng = make(max_len=48, slots=2, buckets=[16], slo=tracker,
               max_retries=0)
    t = eng.start_trace(capacity=512)
    out = {}
    try:
        rng = np.random.RandomState(0)
        prompt = lambda: rng.randint(0, 128, (6,)).astype("int32")  # noqa
        eng.submit(prompt(), 3)
        _drain(eng, 4)
        out["health0"] = eng.health()["slo"]
        out["ticks0"] = tracker.ticks
        plane = faults_mod.FaultPlane(chaos_seed=7, chaos_p=1.0,
                                      chaos_points=("pool.step",),
                                      max_faults=2)
        with faults_mod.injected(plane):
            for wave in range(2):
                for i in range(2):
                    eng.submit(prompt(), 3, request_id="c%d-%d" % (wave, i))
                _drain(eng)
        out["faults"] = plane.fault_count
        out["alert"] = eng.slo_snapshot()
        out["health1"] = eng.health()["slo"]
        out["gauge1"] = eng.metrics.snapshot()[
            "serving_slo_availability_alert_active"]
        for i in range(6):
            eng.submit(prompt(), 2, request_id="r%d" % i)
            _drain(eng, 4)
        out["cleared"] = eng.slo_snapshot()
        out["health2"] = eng.health()["slo"]
        out["gauge2"] = eng.metrics.snapshot()[
            "serving_slo_availability_alert_active"]
        out["names"] = [e.name for e in t.recorder.snapshot()]
    finally:
        eng.stop_trace()
    return out


def test_slo_chaos_alert_flips_and_clears(pair):
    from paddle_tpu.serving import faults as ref_faults

    ref_model, model = pair
    got = _slo_chaos(lambda **k: _engine(model, **k), Objective, SLOTracker,
                     faults)
    want = _slo_chaos(lambda **k: RefEngine(ref_model, **k), RefObjective,
                      RefSLOTracker, ref_faults)
    assert got["health0"] == {"alerts_active": 0, "alerting": [],
                              "ticks": got["ticks0"]}
    assert got["faults"] == want["faults"] == 2
    (obj,) = got["alert"]["objectives"]
    assert obj["alert_active"] and obj["alerts_fired"] == 1
    assert got["alert"]["alerts_active"] == 1
    assert got["health1"]["alerting"] == ["availability"]
    assert got["gauge1"] == 1.0 and got["gauge2"] == 0.0
    (obj,) = got["cleared"]["objectives"]
    assert not obj["alert_active"]
    assert got["health2"]["alerting"] == []
    assert "slo.alert" in got["names"] and "slo.alert_cleared" in got["names"]
    # the same snapshots, field for field, as the reference's
    for k in ("alert", "cleared"):
        assert got[k] == want[k], k
    assert got["health2"] == want["health2"]


def test_slo_snapshot_requires_tracker(pair):
    ref_model, model = pair
    eng = _engine(model, max_len=48, slots=1, buckets=[16])
    ref = RefEngine(ref_model, max_len=48, slots=1, buckets=[16])
    assert eng.slo is None
    assert "slo" not in eng.health()
    with pytest.raises(PreconditionNotMetError, match="SLO"):
        eng.slo_snapshot()
    with pytest.raises(Exception, match="SLO"):
        ref.slo_snapshot()
    # the health body's fields are the reference's
    assert set(eng.health()) == set(ref.health())


def test_slo_prometheus_export(model):
    tracker = SLOTracker([Objective("ttft_p95", "ttft", 0.95,
                                    threshold_s=10.0)],
                         fast_window=2, slow_window=4)
    eng = _engine(model, max_len=48, slots=1, buckets=[16], slo=tracker)
    eng.submit(_prompts(0, (6,))[0], 3)
    _drain(eng, 4)
    text = eng.metrics.render_prometheus()
    for suffix in ("burn_rate_fast", "burn_rate_slow", "alert_active",
                   "budget_remaining"):
        assert "serving_slo_ttft_p95_%s" % suffix in text


def test_shed_edge_is_logged(pair):
    from paddle_tpu.serving import log as ref_slog

    ref_model, model = pair
    out = {}
    for side, make, log_mod in (
            ("port", lambda **k: _engine(model, **k), slog),
            ("ref", lambda **k: RefEngine(ref_model, **k), ref_slog)):
        fake = {"now": 0.0}
        eng = make(max_len=48, slots=1, buckets=[16],
                   clock=lambda: fake["now"])
        buf = io.StringIO()
        with log_mod.logging_to(buf):
            eng.submit(_prompts(0, (6,))[0], 4)
            fake["now"] += 1.0
            while eng.pump(8):
                fake["now"] += 1.0
            with pytest.raises(Exception) as ei:
                eng.submit(_prompts(1, (6,))[0], 8, deadline_s=0.001)
        out[side] = (type(ei.value).__name__,
                     [json.loads(line)["event"]
                      for line in buf.getvalue().splitlines()])
    assert "req.shed" in out["port"][1]
    assert out["port"] == out["ref"]
