"""The port's stdlib HTTP front end, re-pointed from the reference's
``tests/test_http_serving.py`` and held against the reference's front end
on the same weights (CPU).

Most requests run through the handler class against an in-memory socket,
so the handler thread is the test thread and the engine runs in pump mode
(stream iteration pumps it); each such request is sent to the port's and
the reference's handler, and the status codes, headers that matter and
body fields are compared.  The real ``ThreadingHTTPServer`` round trip
runs with the engine's background loop and several client threads, every
socket with a timeout.
"""
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu.serving import ServingEngine as RefEngine
from paddle_tpu.serving.http import _make_handler as ref_make_handler
from torch_parity import (SMALL, FakeClock, RefEngines, assert_greedy_equal,
                          build_pair)

from paddle_tpu_torch import DecodeSession
from paddle_tpu_torch.core.errors import (InvalidArgumentError,
                                          PreconditionNotMetError)
from paddle_tpu_torch.serving import (Objective, ServingEngine,
                                      ServingHTTPFrontend, SLOTracker,
                                      Supervisor, faults, trace,
                                      parse_generate_request)
from paddle_tpu_torch.serving.faults import FaultPlane, FaultSpec
from paddle_tpu_torch.serving.http import _make_handler


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
def _no_leaked_planes():
    yield
    from paddle_tpu.serving import faults as ref_faults
    from paddle_tpu.serving import trace as ref_trace
    trace.uninstall()
    faults.uninstall()
    ref_trace.uninstall()
    ref_faults.uninstall()


def _engine(model, **kw):
    return ServingEngine(model, device="cpu", **kw)


# -- request parsing ----------------------------------------------------------
def test_parse_generate_request_valid():
    from paddle_tpu.serving import parse_generate_request as ref_parse

    body = json.dumps({"prompt": [1, 2, 3], "max_new_tokens": 4,
                       "request_id": "job-1", "deadline_s": 2.5,
                       "priority": "high", "tenant": "acme"}).encode()
    ids, max_new, rid, deadline, prio, tenant = parse_generate_request(body)
    np.testing.assert_array_equal(ids, [1, 2, 3])
    assert ids.dtype == np.int32
    assert (max_new, rid, deadline, prio, tenant) == (4, "job-1", 2.5, 1,
                                                      "acme")
    for b in (body, b'{"prompt": [7], "max_new_tokens": 1}',
              b'{"prompt": [7], "max_new_tokens": 1, "priority": -3}'):
        got, want = parse_generate_request(b), ref_parse(b)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


MALFORMED = (
    (b"not json", "JSON"), (b'[1, 2]', "object"),
    (b'{"max_new_tokens": 3}', "prompt"),
    (b'{"prompt": [], "max_new_tokens": 3}', "prompt"),
    (b'{"prompt": "abc", "max_new_tokens": 3}', "prompt"),
    (b'{"prompt": [1, true], "max_new_tokens": 3}', "prompt"),
    (b'{"prompt": [1]}', "max_new_tokens"),
    (b'{"prompt": [1], "max_new_tokens": 0}', "max_new_tokens"),
    (b'{"prompt": [1], "max_new_tokens": 2.5}', "max_new_tokens"),
    (b'{"prompt": [1], "max_new_tokens": 2, "deadline_s": "soon"}',
     "deadline_s"),
    (b'{"prompt": [1], "max_new_tokens": 2, "deadline_s": true}',
     "deadline_s"),
    (b'{"prompt": [34359738368], "max_new_tokens": 2}', "int32"),
    (b'{"prompt": [1], "max_new_tokens": 2, "request_id": {"a": 1}}',
     "request_id"),
    (b'{"prompt": [1], "max_new_tokens": 2, "request_id": [1]}',
     "request_id"),
    (b'{"prompt": [1], "max_new_tokens": 2, "priority": "urgent"}',
     "priority"),
    (b'{"prompt": [1], "max_new_tokens": 2, "priority": true}', "priority"),
    (b'{"prompt": [1], "max_new_tokens": 2, "priority": 1.5}', "priority"),
    (b'{"prompt": [1], "max_new_tokens": 2, "tenant": 7}', "tenant"))


def test_parse_generate_request_malformed():
    from paddle_tpu.serving import parse_generate_request as ref_parse

    for body, why in MALFORMED:
        with pytest.raises(InvalidArgumentError, match=why):
            parse_generate_request(body)
        with pytest.raises(Exception, match=why):
            ref_parse(body)


# -- the handler against an in-memory socket ------------------------------------
class _FakeSocket:
    """Just enough socket for BaseHTTPRequestHandler."""

    def __init__(self, data: bytes):
        self._in = io.BytesIO(data)
        self.out = io.BytesIO()

    def makefile(self, mode, *args, **kwargs):
        return self._in

    def settimeout(self, value):
        pass

    def sendall(self, data):
        self.out.write(data)

    def close(self):
        pass


def _raw(engine, raw: bytes, ref=False):
    sock = _FakeSocket(raw)
    (ref_make_handler if ref else _make_handler)(engine)(
        sock, ("127.0.0.1", 0), None)
    return sock.out.getvalue()


def _http(engine, method, path, body=b"", ref=False):
    """One request through a front end's handler, in process; returns
    (status code, header dict, body bytes)."""
    req = ("%s %s HTTP/1.1\r\nHost: t\r\nContent-Length: %d\r\n\r\n"
           % (method, path, len(body))).encode() + body
    raw = _raw(engine, req, ref)
    head, _, payload = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").splitlines()
    code = int(lines[0].split()[1])
    headers = dict(h.split(": ", 1) for h in lines[1:] if ": " in h)
    return code, headers, payload


def _both(port_eng, ref_eng, method, path, body=b"", ref_out=None):
    """The same request to both front ends; asserts equal status codes and
    returns the port's response (the reference's is appended to
    ``ref_out`` when given)."""
    got = _http(port_eng, method, path, body)
    want = _http(ref_eng, method, path, body, ref=True)
    assert got[0] == want[0], (method, path, body, got[2], want[2])
    assert ("Retry-After" in got[1]) == ("Retry-After" in want[1])
    if ref_out is not None:
        ref_out.append(want)
    return got


def test_post_generate_streams_tokens_and_status(pair):
    ref_model, model = pair
    cfg = dict(max_len=64, slots=2, buckets=[16])
    prompt = np.random.RandomState(0).randint(0, 128, (6,)).tolist()
    body = json.dumps({"prompt": prompt, "max_new_tokens": 5}).encode()
    ref_out = []
    code, headers, payload = _both(_engine(model, **cfg),
                                   RefEngine(ref_model, **cfg), "POST",
                                   "/generate", body, ref_out)
    assert code == 200
    assert headers["Content-Type"] == "application/x-ndjson"
    lines = [json.loads(x) for x in payload.splitlines()]
    toks = [x["token"] for x in lines if "token" in x]
    final = lines[-1]
    assert final["done"] and final["state"] == "DONE"
    assert final["finish_reason"] == "length"
    assert final["tokens"] == toks and len(toks) == 5
    assert final["prompt_tokens"] == 6 and final["new_tokens"] == 5
    want = DecodeSession(model, max_len=64, buckets=[16],
                         device="cpu").generate(
        np.asarray(prompt, np.int32)[None], 5)[0]
    np.testing.assert_array_equal(np.asarray(toks, np.int32), want)
    ref_lines = [json.loads(x) for x in ref_out[0][2].splitlines()]
    assert set(ref_lines[-1]) == set(final)
    assert_greedy_equal(model, prompt, toks, ref_lines[-1]["tokens"])


def test_error_mapping(pair):
    ref_model, model = pair
    cfg = dict(max_len=64, slots=1, buckets=[16], max_queue=4)
    eng, ref = _engine(model, **cfg), RefEngine(ref_model, **cfg)
    code, _, payload = _both(eng, ref, "POST", "/generate",
                             b'{"prompt": "nope"}')
    assert code == 400 and b"prompt" in payload
    code, _, payload = _both(eng, ref, "POST", "/generate", json.dumps(
        {"prompt": [999999], "max_new_tokens": 2}).encode())
    assert code == 400 and b"vocab" in payload
    for e in (eng, ref):
        e.submit(np.zeros(4, np.int32), 4, request_id="dup")
    code, _, payload = _both(eng, ref, "POST", "/generate", json.dumps(
        {"prompt": [1, 2], "max_new_tokens": 2,
         "request_id": "dup"}).encode())
    assert code == 409 and b"dup" in payload
    while eng.pump(16):
        pass
    # queue full -> retryable 503 with Retry-After (no step needed: the
    # one-slot engine's queue holds the first request)
    cfg1 = dict(max_len=64, slots=1, buckets=[16], max_queue=1)
    stuffed, rstuffed = _engine(model, **cfg1), RefEngine(ref_model, **cfg1)
    for e in (stuffed, rstuffed):
        e.submit(np.zeros(4, np.int32), 4)
    body = json.dumps({"prompt": [1], "max_new_tokens": 2}).encode()
    code, headers, payload = _both(stuffed, rstuffed, "POST", "/generate",
                                   body)
    assert code == 503 and headers.get("Retry-After") == "1"
    assert json.loads(payload)["retryable"] is True
    # draining -> 503 without the retry hint
    stuffed.drain()
    rstuffed._draining = True  # the reference's drain, without its steps
    code, headers, payload = _both(stuffed, rstuffed, "POST", "/generate",
                                   body)
    assert code == 503 and "Retry-After" not in headers
    assert json.loads(payload)["retryable"] is False
    assert _both(eng, ref, "GET", "/nope")[0] == 404
    code, _, payload = _both(eng, ref, "POST", "/nope", b"{}")
    assert code == 404 and b"/generate" in payload
    for bad_len in (b"abc", b"-5"):
        raw = (b"POST /generate HTTP/1.1\r\nHost: t\r\nContent-Length: "
               + bad_len + b"\r\n\r\n")
        got, want = _raw(eng, raw), _raw(ref, raw, ref=True)
        assert b" 400 " in got.splitlines()[0]
        assert got.splitlines()[0] == want.splitlines()[0]
        assert b"Content-Length" in got
    raw = (b"POST /generate HTTP/1.1\r\nHost: t\r\n"
           b"Content-Length: 8000000000\r\n\r\n")
    got = _raw(eng, raw)
    assert b" 413 " in got.splitlines()[0] and b"limit" in got
    assert got.splitlines()[0] == _raw(ref, raw, ref=True).splitlines()[0]


def test_get_metrics_renders_prometheus(model):
    eng = _engine(model, max_len=64, slots=1, buckets=[16])
    s = eng.submit(np.zeros(4, np.int32), 3)
    while eng.pump(8):
        pass
    assert s.result(timeout_s=0).state == "DONE"
    code, headers, payload = _http(eng, "GET", "/metrics")
    assert code == 200
    assert headers["Content-Type"].startswith("text/plain")
    text = payload.decode()
    assert "# TYPE serving_ttft_seconds histogram" in text
    assert "serving_requests_completed_total 1" in text
    assert text == eng.metrics.render_prometheus()


# -- /healthz, /slo and the /debug endpoints -----------------------------------
def test_healthz_body_is_the_full_snapshot(pair):
    ref_model, model = pair
    eng = _engine(model, max_len=32, slots=1, buckets=[8])
    ref = RefEngine(ref_model, max_len=32, slots=1, buckets=[8])
    code, _, payload = _both(eng, ref, "GET", "/healthz")
    body = json.loads(payload)
    assert code == 200
    for field in ("state", "healthy", "live_requests", "queue_depth",
                  "loop_alive", "draining", "ticks_total", "last_error",
                  "last_error_at", "last_error_kind", "restarts",
                  "recoveries", "requests_recovered", "ticks_stalled",
                  "flight_dump", "started_at", "uptime_s"):
        assert field in body, field
    # the reference's fields, every one of them
    assert set(body) == set(json.loads(_http(ref, "GET", "/healthz",
                                             ref=True)[2]))
    eng._health.note_error(1.25, RuntimeError("boom"), "loop")
    body = json.loads(_http(eng, "GET", "/healthz")[2])
    assert "boom" in body["last_error"]
    assert body["last_error_at"] == 1.25
    assert body["last_error_kind"] == "loop"


def test_healthz_started_at_and_uptime_track_the_engine_clock(model):
    fake = {"now": 100.0}
    eng = _engine(model, max_len=32, slots=1, buckets=[8],
                  clock=lambda: fake["now"])
    body = json.loads(_http(eng, "GET", "/healthz")[2])
    assert body["started_at"] == 100.0 and body["uptime_s"] == 0.0
    fake["now"] = 103.5
    body = json.loads(_http(eng, "GET", "/healthz")[2])
    assert body["started_at"] == 100.0 and body["uptime_s"] == 3.5


def test_slo_endpoint(pair):
    from paddle_tpu.serving import Objective as RefObjective
    from paddle_tpu.serving import SLOTracker as RefSLOTracker

    ref_model, model = pair
    eng = _engine(model, max_len=32, slots=1, buckets=[8])
    ref = RefEngine(ref_model, max_len=32, slots=1, buckets=[8])
    code, _, payload = _both(eng, ref, "GET", "/slo")
    assert code == 404 and b"SLOTracker" in payload
    bodies = {}
    for side, make, obj, trk, is_ref in (
            ("port", lambda **k: _engine(model, **k), Objective, SLOTracker,
             False),
            ("ref", lambda **k: RefEngine(ref_model, **k), RefObjective,
             RefSLOTracker, True)):
        tracker = trk([obj("availability", "availability", 0.99),
                       obj("ttft_p95", "ttft", 0.95, threshold_s=10.0)],
                      fast_window=2, slow_window=8)
        e = make(max_len=64, slots=1, buckets=[16], slo=tracker)
        code, _, _ = _http(e, "POST", "/generate", json.dumps(
            {"prompt": [3, 1, 4], "max_new_tokens": 3}).encode(),
            ref=is_ref)
        assert code == 200
        code, headers, payload = _http(e, "GET", "/slo", ref=is_ref)
        assert code == 200
        assert headers["Content-Type"] == "application/json"
        health = json.loads(_http(e, "GET", "/healthz", ref=is_ref)[2])
        bodies[side] = (json.loads(payload), health["slo"], tracker.ticks)
    body, health_slo, ticks = bodies["port"]
    assert body["fast_window_ticks"] == 2 and body["alerts_active"] == 0
    names = {o["name"]: o for o in body["objectives"]}
    assert set(names) == {"availability", "ttft_p95"}
    assert names["ttft_p95"]["threshold_s"] == 10.0
    assert names["availability"]["total_good"] == 1
    assert health_slo == {"alerts_active": 0, "alerting": [],
                          "ticks": ticks}
    # the reference's body, field for field
    assert body == bodies["ref"][0]


def test_healthz_stays_200_while_degraded_and_carries_the_level(model):
    eng = _engine(model, max_len=64, slots=1, buckets=[16],
                  slo=SLOTracker([Objective("ttft_p95", "ttft", 0.95,
                                            threshold_s=0.5)],
                                 fast_window=2, slow_window=4),
                  degrade=True)
    body = json.loads(_http(eng, "GET", "/healthz")[2])
    assert body["degraded"] == 0 and body["preempted_requests"] == 0
    eng._set_degrade_level(3, ["ttft_p95"])
    stream = eng.submit(np.zeros(4, np.int32), 2, priority="high")
    code, _, payload = _http(eng, "GET", "/healthz")
    body = json.loads(payload)
    assert code == 200 and body["healthy"] is True
    assert body["state"] == "serving" and body["degraded"] == 3
    slo_body = json.loads(_http(eng, "GET", "/slo")[2])
    assert slo_body["degradation"]["level"] == 3
    assert slo_body["degradation"]["enabled"] is True
    code, headers, payload = _http(eng, "POST", "/generate", json.dumps(
        {"prompt": [1, 2], "max_new_tokens": 2,
         "priority": "low"}).encode())
    assert code == 503 and "Retry-After" in headers
    assert json.loads(payload)["retryable"] is True
    assert b"tightened" in payload or b"ladder" in payload
    assert eng.metrics.snapshot()["serving_admission_tightened_total"] == 1
    while eng.pump(8):
        pass
    assert stream.result(timeout_s=0).state == "DONE"


def test_healthz_restoring_503_retry_after_then_200(pair):
    """While a journal replay owns the engine, /healthz answers 503 WITH
    the engine's Retry-After hint (a rollout controller waits instead of
    killing it), submits are deferred with a live stream, and the flip
    back to 200 happens when the replay ends -- as the reference's front
    end does."""
    ref_model, model = pair
    eng = _engine(model, max_len=64, slots=1, buckets=[16])
    ref_eng = RefEngine(ref_model, max_len=64, slots=1, buckets=[16])
    for e in (eng, ref_eng):
        e._begin_restore(retry_after_s=2.5)
    ref_out = []
    code, headers, payload = _both(eng, ref_eng, "GET", "/healthz",
                                   ref_out=ref_out)
    body = json.loads(payload)
    assert code == 503
    assert body["state"] == "restoring" and body["healthy"] is False
    assert body["restoring"] is True and body["retry_after_s"] == 2.5
    assert headers.get("Retry-After") == ref_out[0][1]["Retry-After"] == "3"
    stream = eng.submit(np.zeros(4, np.int32), 3)
    assert eng.live_requests == 0 and eng.queue_depth == 0
    for e in (eng, ref_eng):
        e._end_restore()
    code, headers, payload = _both(eng, ref_eng, "GET", "/healthz")
    assert code == 200 and "Retry-After" not in headers
    assert json.loads(payload)["restoring"] is False
    assert eng.live_requests == 1
    while eng.pump(8):
        pass
    assert stream.result(timeout_s=0).state == "DONE"


def test_debug_trace_and_flightrec_endpoints(pair):
    from paddle_tpu.serving import trace as ref_trace

    ref_model, model = pair
    eng = _engine(model, max_len=64, slots=1, buckets=[16])
    ref = RefEngine(ref_model, max_len=64, slots=1, buckets=[16])
    code, _, payload = _both(eng, ref, "GET", "/debug/flightrec")
    assert code == 404 and b"start_trace" in payload
    assert _both(eng, ref, "GET", "/debug/trace?rid=x")[0] == 404
    timelines = {}
    for side, e, is_ref in (("port", eng, False), ("ref", ref, True)):
        e.start_trace(capacity=512)
        try:
            code, _, _ = _http(e, "POST", "/generate", json.dumps(
                {"prompt": [3, 1, 4], "max_new_tokens": 3,
                 "request_id": "job-1"}).encode(), ref=is_ref)
            assert code == 200
            code, _, payload = _http(e, "GET", "/debug/trace?rid=job-1",
                                     ref=is_ref)
            assert code == 200
            timelines[side] = [x["name"]
                               for x in json.loads(payload)["events"]]
            code, _, payload = _http(e, "GET", "/debug/trace", ref=is_ref)
            assert code == 400 and b"rid" in payload
            assert _http(e, "GET", "/debug/trace?rid=ghost",
                         ref=is_ref)[0] == 404
            code, _, payload = _http(e, "GET", "/debug/flightrec",
                                     ref=is_ref)
            assert code == 200
            rec = json.loads(payload)
            assert rec["capacity"] == 512 and rec["deep_timing"] is False
            assert rec["dropped"] == 0 and rec["events"]
        finally:
            e.stop_trace()
    assert timelines["port"][0] == "req.queued"
    assert timelines["port"][-1] == "req.done"
    # the request's timeline has the reference's events, in its order
    assert timelines["port"] == timelines["ref"]
    assert _http(eng, "GET", "/debug/flightrec")[0] == 200
    assert ref_trace.active() is None


# -- robustness: wedge, restart, shedding, the disconnect seam --------------------
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_healthz_flips_200_503_200_across_wedge_and_restart(model):
    clock = FakeClock()
    eng = _engine(model, max_len=32, slots=1, buckets=[8], clock=clock)
    sup = Supervisor(eng, stall_timeout_s=0.5, clock=clock)
    code, _, payload = _http(eng, "GET", "/healthz")
    body = json.loads(payload)
    assert code == 200 and body["healthy"] and body["state"] == "idle"
    eng._health.note_tick_start(clock())
    clock.advance(1.0)
    assert sup.check_once() == ["stall-detected"]
    code, _, payload = _http(eng, "GET", "/healthz")
    body = json.loads(payload)
    assert code == 503
    assert body["state"] == "wedged" and body["ticks_stalled"] == 1
    eng._health.note_tick_end(clock())
    code, _, payload = _http(eng, "GET", "/healthz")
    assert code == 200 and json.loads(payload)["healthy"]
    eng.start()
    try:
        t_old = eng._thread

        def boom():
            raise SystemExit

        eng._tick = boom
        t_old.join(timeout=10.0)
        assert not t_old.is_alive()
        del eng._tick
        assert _http(eng, "GET", "/healthz")[0] == 503  # loop-dead
        assert sup.check_once() == ["loop-restarted"]
        code, _, payload = _http(eng, "GET", "/healthz")
        assert code == 200 and json.loads(payload)["restarts"] == 1
    finally:
        eng.shutdown()
    # stopped: 503
    assert _http(eng, "GET", "/healthz")[0] == 503


def test_unattainable_deadline_maps_to_503_with_retry_after(model):
    eng = _engine(model, max_len=128, slots=1, buckets=[8])
    eng.submit(np.zeros(4, np.int32), 3)
    while eng.pump(8):
        pass
    eng.submit(np.zeros(4, np.int32), 100)
    eng.pump(2)
    code, headers, payload = _http(eng, "POST", "/generate", json.dumps(
        {"prompt": [1, 2], "max_new_tokens": 20,
         "deadline_s": 1e-9}).encode())
    assert code == 503 and int(headers["Retry-After"]) >= 1
    body = json.loads(payload)
    assert body["retryable"] is True and "shed" in body["error"]
    assert eng.metrics.snapshot()["serving_requests_shed_total"] == 1
    while eng.pump(200):
        pass


def test_http_write_fault_cancels_like_a_disconnect(pair):
    from paddle_tpu.serving import faults as ref_faults

    ref_model, model = pair
    cfg = dict(max_len=64, slots=1, buckets=[16], cache_layout="paged",
               block_size=8)
    out = {}
    for side, e, mod, is_ref in (
            ("port", _engine(model, **cfg), faults, False),
            ("ref", RefEngine(ref_model, **cfg), ref_faults, True)):
        free0 = e.cache_stats()["free_blocks"]
        plane = mod.FaultPlane([mod.FaultSpec(
            "http.write", error=ConnectionResetError("injected disconnect"),
            after=2, times=1)])
        with mod.injected(plane):
            code, _, payload = _http(e, "POST", "/generate", json.dumps(
                {"prompt": [3, 1, 4], "max_new_tokens": 30}).encode(),
                ref=is_ref)
        lines = [json.loads(x) for x in payload.splitlines()]
        out[side] = (code, len(lines), all("token" in x for x in lines),
                     e.live_requests,
                     e.cache_stats()["free_blocks"] == free0,
                     e.metrics.snapshot()[
                         "serving_requests_cancelled_total"])
    assert out["port"] == (200, 2, True, 0, True, 1)
    assert out["port"] == out["ref"]


# -- the real server ----------------------------------------------------------------
def test_real_server_round_trip(model, refs):
    prompts = [[3, 1, 4], [1, 5, 9, 2, 6], [5, 3, 5, 8], [9, 7, 9]]
    cfg = dict(max_len=64, slots=2, buckets=[16])
    ref = refs.run([np.asarray(p, np.int32) for p in prompts], [4] * 4,
                   **cfg)
    eng = _engine(model, **cfg).start()
    front = ServingHTTPFrontend(eng).start()
    base = "http://%s:%d" % front.address
    results = [None] * len(prompts)

    def client(i):
        req = urllib.request.Request(
            base + "/generate",
            data=json.dumps({"prompt": prompts[i],
                             "max_new_tokens": 4}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            results[i] = (resp.status,
                          [json.loads(line) for line in resp])

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=90.0)
        assert not any(t.is_alive() for t in threads)
        with urllib.request.urlopen(base + "/metrics", timeout=30) as resp:
            text = resp.read().decode()
        assert "serving_requests_completed_total 4" in text
        with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
            assert resp.status == 200
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(
                base + "/generate", data=b"bad"), timeout=30)
        assert ei.value.code == 400
        assert eng.drain(timeout_s=30.0) is True
        eng.shutdown()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/healthz", timeout=30)
        assert ei.value.code == 503
    finally:
        front.shutdown()
        eng.shutdown()
    for p, (status, lines), r in zip(prompts, results, ref):
        assert status == 200
        assert lines[-1]["done"] and lines[-1]["new_tokens"] == 4
        assert [x["token"] for x in lines[:-1]] == lines[-1]["tokens"]
        assert_greedy_equal(model, p, lines[-1]["tokens"], r.tokens)


def test_frontend_lifecycle_guards(model):
    eng = _engine(model, max_len=64, slots=2, buckets=[16])
    f1 = ServingHTTPFrontend(eng)
    f1.shutdown()
    f1.shutdown()
    with pytest.raises(PreconditionNotMetError):
        f1.start()
    with pytest.raises(PreconditionNotMetError):
        f1.serve_forever()
    f2 = ServingHTTPFrontend(eng).start()
    try:
        assert f2.start() is f2
        with pytest.raises(PreconditionNotMetError):
            f2.serve_forever()
    finally:
        f2.shutdown()
