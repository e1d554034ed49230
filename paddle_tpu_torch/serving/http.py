"""A stdlib HTTP front end over the serving engine (counterpart of the
reference's ``serving/http.py``).

No dependency beyond ``http.server`` and ``json``: the engine does the
serving work, this module maps HTTP onto it.

- ``POST /generate`` -- JSON body ``{"prompt": [ids...],
  "max_new_tokens": n, "request_id"?: any, "deadline_s"?: s,
  "priority"?: int | "low" | "normal" | "high", "tenant"?: str}``; the
  response streams one JSON line per token (``{"token": id}``,
  ``application/x-ndjson``) as the decode step emits it, then one
  terminal line carrying the ``StreamStatus`` record.  A client that
  disconnects mid-stream gets its request CANCELLED: its slot and blocks
  go back to the allocator.
- ``GET /metrics`` -- the Prometheus text exposition of the engine's
  registry.
- ``GET /healthz`` -- the engine's lock-free ``health()`` snapshot: 200
  while healthy (idle, serving, draining, degraded), 503 while a tick is
  wedged past the supervisor's stall timeout, the loop thread is dead,
  the engine was shut down, or it is RESTORING from a journal (then with
  the engine's ``Retry-After`` hint).
- ``GET /slo`` -- the SLO tracker's snapshot (404 without one).
- ``GET /debug/trace?rid=<id>`` -- one request's trace timeline (400
  without ``rid``, 404 for an unknown id or when no tracer was ever
  active); ``GET /debug/flightrec`` -- the whole flight recorder (404
  when no tracer was ever active).

Errors map from the engine's typed vocabulary: ``InvalidArgumentError``
-> 400, ``DuplicateRequestError`` -> 409, ``QueueFullError`` -> 503 with
``Retry-After: 1``, ``DeadlineUnattainableError`` and
``AdmissionTightenedError`` -> 503 with the engine's ``Retry-After``
hint, draining -> 503 without one, unknown paths -> 404.  A body over
8 MiB -> 413, a bad ``Content-Length`` -> 400.

With ``engine.start()`` handler threads block on their streams (real
serving); without it a handler pumps the engine inline through the stream
iterator (the engine lock serializes ticks), which the tests use.
``ThreadingHTTPServer`` gives each connection its own thread either way.
The handlers never touch the device: tokens reach them through the
stream's queue, and health and metrics are host state.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs

import numpy as np

from ..core.errors import (InvalidArgumentError, NotFoundError,
                           PreconditionNotMetError)
from ..inference.generation import DuplicateRequestError
from . import faults
from .engine import (AdmissionTightenedError, DeadlineUnattainableError,
                     QueueFullError, ServingEngine, _normalize_priority)

__all__ = ["ServingHTTPFrontend", "parse_generate_request"]

# POST body cap: prompts are token-id arrays (~8 ASCII bytes per id),
# so even a max_position-scale prompt fits comfortably in 8 MiB; the
# read buffers the WHOLE body before validation, so the cap is the OOM
# guard, not a protocol nicety.
_MAX_BODY_BYTES = 8 << 20


def parse_generate_request(body: bytes) -> Tuple[np.ndarray, int,
                                                 object, Optional[float],
                                                 int, Optional[str]]:
    """Validate a ``POST /generate`` body into
    ``(ids int32[L], max_new_tokens, request_id, deadline_s, priority,
    tenant)``.

    ``priority`` accepts an int or a named class
    (``PRIORITY_CLASSES``: "low"/"normal"/"high") and normalizes to the
    int the scheduler orders by; ``tenant`` is an optional string
    fairness-cap key.  Raises :class:`InvalidArgumentError` with an
    actionable message for every malformed shape — the handler maps it
    to a 400 whose body the caller can fix from.  Value-range checks
    (budget vs max_len, bucket coverage, queue depth) stay with the
    engine, which owns them."""
    try:
        payload = json.loads(body.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise InvalidArgumentError(
            "request body is not valid JSON: %s" % (e,))
    if not isinstance(payload, dict):
        raise InvalidArgumentError(
            "request body must be a JSON object with 'prompt' and "
            "'max_new_tokens', got %s" % type(payload).__name__)
    prompt = payload.get("prompt")
    if not isinstance(prompt, list) or not prompt or not all(
            isinstance(t, int) and not isinstance(t, bool)
            for t in prompt):
        raise InvalidArgumentError(
            "'prompt' must be a non-empty JSON array of integer token "
            "ids, got %r" % (prompt,))
    if not all(-2 ** 31 <= t < 2 ** 31 for t in prompt):
        # np.asarray(..., int32) would raise a bare OverflowError on
        # NumPy 2.x before the engine's vocab check could 400 it
        raise InvalidArgumentError(
            "'prompt' token ids must fit int32; the engine rejects "
            "anything outside the model's vocab anyway")
    max_new = payload.get("max_new_tokens")
    if not isinstance(max_new, int) or isinstance(max_new, bool) \
            or max_new < 1:
        raise InvalidArgumentError(
            "'max_new_tokens' must be an integer >= 1, got %r"
            % (max_new,))
    deadline = payload.get("deadline_s")
    if deadline is not None and (not isinstance(deadline, (int, float))
                                 or isinstance(deadline, bool)):
        # bool is an int subclass: `true` would silently become a 1.0s
        # deadline and EXPIRE the request instead of 400ing the typo
        raise InvalidArgumentError(
            "'deadline_s' must be a number of seconds (or absent), "
            "got %r" % (deadline,))
    rid = payload.get("request_id")
    if rid is not None and not isinstance(rid, (str, int, float)):
        # a JSON object/array id is unhashable — the pool's duplicate
        # check would die with a bare TypeError instead of a 400
        raise InvalidArgumentError(
            "'request_id' must be a JSON string or number (or absent), "
            "got %s" % type(rid).__name__)
    # one normalization rule for the HTTP boundary and the Python API:
    # _normalize_priority already rejects unknown classes, bools (an
    # int subclass — `true` would silently jump the queue) and floats
    # with a 400-ready InvalidArgumentError naming the classes
    priority = _normalize_priority(payload.get("priority", 0))
    tenant = payload.get("tenant")
    if tenant is not None and not isinstance(tenant, str):
        raise InvalidArgumentError(
            "'tenant' must be a JSON string fairness-cap key (or "
            "absent), got %s" % type(tenant).__name__)
    return (np.asarray(prompt, np.int32), max_new, rid,
            None if deadline is None else float(deadline),
            priority, tenant)


def _make_handler(engine: ServingEngine, quiet: bool = True):
    """The request-handler class, closed over ONE engine (the stdlib
    server API wants a class, not an instance)."""

    class _Handler(BaseHTTPRequestHandler):
        # HTTP/1.0 framing: no Content-Length on the streamed response,
        # the connection close delimits it — the simplest protocol that
        # streams through every stdlib client
        server_version = "paddle-tpu-torch-serving"
        # socket timeout (BaseHTTPRequestHandler.setup applies it via
        # connection.settimeout): a client that stalls mid-body or
        # stops reading the stream raises OSError/timeout instead of
        # hanging the connection thread forever — the except-OSError
        # disconnect-cancels path needs the stall to become an error
        timeout = 60.0

        def log_message(self, fmt, *args):  # noqa: D102 - stdlib hook
            if not quiet:
                BaseHTTPRequestHandler.log_message(self, fmt, *args)

        def _send_json(self, code: int, obj: dict, headers=()):
            body = (json.dumps(obj) + "\n").encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 - stdlib casing
            path, _, query = self.path.partition("?")
            if path == "/healthz":
                # lock-free on purpose: the probe must answer while a
                # wedged tick holds the engine lock.  The body is the
                # FULL health() snapshot (last error what/when/kind,
                # restart/stall counters, flight-recorder dump), not
                # just a status code
                h = engine.health()
                headers = ()
                if h.get("state") == "restoring":
                    # transient: the probe gets the engine's back-off
                    # hint and waits out the journal replay
                    ra = h.get("retry_after_s") or 1.0
                    headers = (("Retry-After",
                                str(max(1, int(-(-ra // 1))))),)
                self._send_json(200 if h["healthy"] else 503, h,
                                headers=headers)
                return
            if path == "/debug/trace":
                rid = parse_qs(query).get("rid", [None])[0]
                if rid is None:
                    self._send_json(400, {
                        "error": "rid query parameter required: "
                                 "GET /debug/trace?rid=<request id>"})
                    return
                try:
                    self._send_json(200, engine.request_trace(rid))
                except (NotFoundError, PreconditionNotMetError) as e:
                    self._send_json(404, {"error": str(e)})
                return
            if path == "/debug/flightrec":
                try:
                    self._send_json(200, engine.flight_recorder())
                except PreconditionNotMetError as e:
                    self._send_json(404, {"error": str(e)})
                return
            if path == "/slo":
                # objectives + burn rates + alert state (serving/slo.py);
                # 404 when the engine declared no objectives — absence
                # is a configuration fact, not an empty result
                try:
                    self._send_json(200, engine.slo_snapshot())
                except PreconditionNotMetError as e:
                    self._send_json(404, {"error": str(e)})
                return
            if path != "/metrics":
                self._send_json(404, {"error": "unknown path %r; the "
                                      "front end serves POST /generate, "
                                      "GET /metrics, GET /healthz, "
                                      "GET /slo, "
                                      "GET /debug/trace?rid=<id> and "
                                      "GET /debug/flightrec"
                                      % self.path})
                return
            body = engine.metrics.render_prometheus().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):  # noqa: N802 - stdlib casing
            if self.path.split("?", 1)[0] != "/generate":
                self._send_json(404, {"error": "unknown path %r; the "
                                      "front end serves POST /generate, "
                                      "GET /metrics and GET /healthz"
                                      % self.path})
                return
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                length = -1
            if length < 0:
                # a negative length would make rfile.read() block until
                # client EOF, hanging this connection thread forever
                self._send_json(400, {"error": "Content-Length header "
                                      "must be a non-negative integer"})
                return
            if length > _MAX_BODY_BYTES:
                # rfile.read(length) buffers the whole body BEFORE any
                # validation: without a cap one request OOMs the server
                self._send_json(413, {"error": "request body %d bytes "
                                      "exceeds the %d-byte limit (a "
                                      "token-id prompt is ~8 bytes per "
                                      "token)" % (length,
                                                  _MAX_BODY_BYTES)})
                return
            try:
                ids, max_new, rid, deadline, priority, tenant = \
                    parse_generate_request(self.rfile.read(length))
                stream = engine.submit(ids, max_new, request_id=rid,
                                       deadline_s=deadline,
                                       priority=priority, tenant=tenant)
            except (DeadlineUnattainableError,
                    AdmissionTightenedError) as e:
                # deadline-aware load shedding AND the degradation
                # ladder's tighten-admission rung: both retryable, with
                # the engine's own hint as Retry-After
                self._send_json(
                    503, {"error": str(e), "retryable": True},
                    headers=(("Retry-After",
                              str(max(1, int(-(-e.retry_after_s // 1)))),
                              ),))
                return
            except QueueFullError as e:
                # the engine's RETRYABLE backpressure, mapped verbatim
                self._send_json(503, {"error": str(e), "retryable": True},
                                headers=(("Retry-After", "1"),))
                return
            except DuplicateRequestError as e:
                self._send_json(409, {"error": str(e)})
                return
            except InvalidArgumentError as e:
                self._send_json(400, {"error": str(e)})
                return
            except PreconditionNotMetError as e:  # draining/shut down
                self._send_json(503, {"error": str(e),
                                      "retryable": False})
                return
            try:
                # header flush is inside the try: a client gone before
                # end_headers() must cancel, same as one gone mid-stream
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                for tok in stream:
                    # `http.write` seam: an injected OSError here is a
                    # client disconnect — the except path below cancels
                    # the request and reclaims its slot/blocks
                    faults.fire("http.write")
                    self.wfile.write(
                        (json.dumps({"token": int(tok)}) + "\n").encode())
                    self.wfile.flush()
                st = stream.result(timeout_s=None)
                self.wfile.write((json.dumps({
                    "done": True,
                    "request_id": st.request_id,
                    "state": st.state,
                    "finish_reason": st.finish_reason,
                    "prompt_tokens": st.prompt_tokens,
                    "new_tokens": st.new_tokens,
                    "tokens": [int(t) for t in st.tokens],
                    "ttft_s": st.ttft_s,
                    "total_s": st.total_s,
                    "error": st.error,
                }) + "\n").encode())
            except OSError:
                # the consumer hung up (BrokenPipe/ConnectionReset/
                # aborts/timeouts all surface as OSError subclasses):
                # routine, not worth a socketserver traceback
                pass
            finally:
                # free the slot and its KV blocks on EVERY exit path,
                # not just OSError: an engine failure surfacing through
                # the stream iterator (inline-pump pool.step blowing
                # up) must also reclaim them, or the request stays live
                # decoding for nobody; no-op when the request already
                # reached a terminal state (cancel is idempotent)
                engine.cancel(stream.request_id)

    return _Handler


class ServingHTTPFrontend:
    """Own a ``ThreadingHTTPServer`` bound to ``engine``.

    ``port=0`` binds an ephemeral port (tests); ``address`` reports the
    bound ``(host, port)``.  ``start()`` serves from a daemon thread and
    returns self; ``serve_forever()`` serves on the calling thread;
    ``shutdown()`` stops the server and closes the listening socket —
    the ENGINE's lifecycle stays the caller's (a front end restart must
    not drain in-flight requests)."""

    def __init__(self, engine: ServingEngine, host: str = "127.0.0.1",
                 port: int = 0, quiet: bool = True):
        self.engine = engine
        self._server = ThreadingHTTPServer(
            (host, port), _make_handler(engine, quiet=quiet))
        # connection threads die with the process; the engine drains
        # independently of them
        self._server.daemon_threads = True
        # serializes start()/shutdown(): the serve thread handle is
        # shared state, and a start racing a shutdown could leak a
        # second serve thread on the closed socket
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        # True once a serve loop was (or is about to be) entered —
        # BaseServer.shutdown() waits on an event only serve_forever
        # sets, so calling it with no loop ever run blocks forever
        self._served = False
        # True once shutdown() closed the listening socket: a later
        # start() would spawn a serve thread on a dead fd that dies
        # with an unraised selector error while clients see
        # connection-refused — fail loudly instead
        self._closed = False

    @property
    def address(self) -> Tuple[str, int]:
        host, port = self._server.server_address[:2]
        return host, port

    def start(self) -> "ServingHTTPFrontend":
        with self._lock:
            self._check_open()
            if self._served and self._thread is None:
                # a blocking serve_forever() loop owns the server; a
                # second loop on one socket would race BaseServer's
                # one-shot shutdown event and leave a loop spinning on
                # a closed fd at shutdown
                raise PreconditionNotMetError(
                    "frontend is already serving on the calling "
                    "thread (serve_forever); one serve loop per "
                    "frontend")
            if self._thread is None:
                self._served = True
                self._thread = threading.Thread(
                    target=self._server.serve_forever,
                    name="serving-http-frontend", daemon=True)
                self._thread.start()
        return self

    def serve_forever(self) -> None:
        with self._lock:
            self._check_open()
            if self._served:
                raise PreconditionNotMetError(
                    "frontend is already serving (start() or a prior "
                    "serve_forever); one serve loop per frontend")
            self._served = True
        self._server.serve_forever()

    def _check_open(self) -> None:
        if self._closed:
            raise PreconditionNotMetError(
                "ServingHTTPFrontend was shut down (listening socket "
                "closed); build a new frontend — the engine's "
                "lifecycle is separate and unaffected")

    def shutdown(self) -> None:
        # the lock serializes against start(); the serve thread never
        # takes it, so joining under the lock cannot deadlock.  Skipping
        # BaseServer.shutdown() when no loop ever ran matters doubly
        # here: the hang would now pin the lock too.
        with self._lock:
            if not self._closed:
                if self._served:
                    self._server.shutdown()
                self._server.server_close()
                self._closed = True
            if self._thread is not None:
                self._thread.join(timeout=10.0)
                self._thread = None
