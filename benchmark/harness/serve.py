"""The serving cells: the ``ServingEngine`` with its own loop thread
(``start()``), fed by ``submit`` from an open loop (``open_loop``:
requests due at Poisson arrival times drawn from the seed, whatever the
engine does) or a closed loop
(``closed_loop``: each client sends its next request when its last one
finished).

Every token is stamped on the host's clock as the pool delivers it (a
wrapper around the pool's ``on_token`` hook, which the engine installs).
The open loop's window holds the requests due in ``--seconds``; each is
followed to its last token, with the load kept up, for at most
``grace_s`` more.  A traced run also installs the engine's tracer
(``deep_timing`` off) for the whole run and profiles the device over
``stretch_s`` right after the window, under the same load.  The window
opens after ``preroll_s`` of the same traffic, so that it measures the
engine at its steady load.

After the window the engine and the model are freed and the reference
runs once over a sample of the finished requests, drawn from the seed
with the longest among them.
"""
from __future__ import annotations

import gc
import math
import queue
import time
from typing import Dict, List

import numpy as np
import torch

from harness import traffic, weights
from harness.devtrace import Stretch
from reference import served_gaps


def port_kwargs(cfg: dict) -> dict:
    """The program's model arguments for a configuration file."""
    return dict(vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
                num_layers=cfg["num_layers"], num_heads=cfg["num_heads"],
                intermediate_size=cfg["intermediate_size"],
                max_position=cfg["max_position"], causal=cfg["causal"],
                activation=cfg["activation"],
                normalize_before=cfg["normalize_before"])


class _Timeline:
    """The run's fixed times on the host clock, from ``t_begin``: the
    window opens after ``preroll_s`` of traffic (set-up: the engine
    reaches its steady load) and closes ``--seconds`` later.  A traced
    run then starts the profiler, waits ``settle_s`` under the same load
    and records ``stretch_s``: starting and stopping the profiler hold
    the process for seconds, which must not fall in the window.  Whichever
    loop drives the traffic polls it; the profiler's transitions run on
    the engine's thread between two ticks."""

    SETTLE_S = 1.0

    def __init__(self, run, engine, mix, t_begin):
        self.run, self.engine = run, engine
        self.t0 = t_begin + mix["preroll_s"]
        self.t1 = self.t0 + run.seconds
        self.events = [(self.t0, self._open)]
        if run.trace:
            a = self.t1 + self.SETTLE_S
            self.events += [(self.t1, self._prepare), (a, self._profile),
                            (a + mix["stretch_s"], self._unprofile)]
        self.stretch = None
        self._pending = []
        self.bounds = {}
        self.steps = None
        self.prefix0 = self.steps0 = None

    def next_event(self) -> float:
        return self.events[0][0] if self.events else math.inf

    def poll(self, now: float) -> None:
        while self.events and now >= self.events[0][0]:
            at, action = self.events.pop(0)
            if action == self._open:
                action()
            else:
                self._pending.append(action)

    def between_ticks(self) -> None:
        """Runs the profiler's due transitions on the engine's own thread,
        before its next tick: nothing else then runs on the card."""
        while self._pending:
            self._pending.pop(0)()

    @property
    def busy(self) -> bool:
        return bool(self.events or self._pending)

    def _open(self):
        self.run.window_start()
        self.prefix0 = self.engine.prefix_stats()
        self.steps0 = self.engine.pool.decode_steps_total

    def _prepare(self):
        self.bounds["held_from"] = time.perf_counter()
        self.stretch = Stretch(self.run.device).prepare()
        self.bounds["prepared"] = time.perf_counter()

    def _profile(self):
        self.steps = [self.engine.pool.decode_steps_total, None]
        self.stretch.start()
        self.bounds["start"] = time.perf_counter()

    def _unprofile(self):
        self.bounds["stop"] = time.perf_counter()
        self.steps[1] = self.engine.pool.decode_steps_total
        self.stretch.stop()
        self.bounds["released"] = time.perf_counter()


def _engine(P, model, e: dict, device):
    return P.ServingEngine(
        model, max_len=e["max_len"], slots=e["slots"],
        max_queue=e["max_queue"], device=device, cache_layout="paged",
        block_size=e["block_size"], num_blocks=e["num_blocks"],
        cache_dtype=e["cache_dtype"],
        prefill_chunk_tokens=e["prefill_chunk_tokens"],
        prefix_sharing=e["prefix_sharing"])


def _warm_up(engine, vocab: int, seed: int):
    """Two requests that meet every step shape of the window: the chunk
    step (a prompt of two chunks), the decode step, a prefix hit."""
    rng = traffic.rng_for(seed, "warmup")
    chunk = engine.pool.prefix_stats()["prefill_chunk_tokens"]
    a = rng.integers(0, vocab, chunk + 44).astype(np.int64)
    engine.submit(a, 4, request_id="warm-a").result()
    b = np.concatenate([a[:chunk + 32], rng.integers(0, vocab, 20)])
    engine.submit(b, 4, request_id="warm-b").result()
    engine.reset_prefix_stats()


def run_serve(run) -> dict:
    import paddle_tpu_torch as P
    from paddle_tpu_torch.core.errors import UnavailableError

    cfg, mix, dev = run.cfg, run.mix, run.device
    model = P.TransformerLM(**port_kwargs(cfg), dropout=0.0, device=dev,
                            seed=run.seed)
    weights.load_into(model.named_parameters(), cfg, run.seed)
    model.eval()
    engine = _engine(P, model, mix["engine"], dev)
    pool = engine.pool
    stamps: Dict[int, list] = {}
    budgets: Dict[int, int] = {}
    finished: "queue.Queue[int]" = queue.Queue()
    delivered = pool.on_token

    def on_token(rid, tok):
        seen = stamps.get(rid)
        if seen is not None:
            seen.append((time.perf_counter(), pool.decode_steps_total))
            if len(seen) == budgets[rid]:
                finished.put(rid)
        delivered(rid, tok)

    pool.on_token = on_token
    engine.start()
    try:
        _warm_up(engine, cfg["real_vocab_size"], run.seed)
        keys = engine.compile_counts()
        tracer = None
        if run.trace:
            tracer = engine.start_trace(capacity=mix["trace_capacity"])
        requests: Dict[int, traffic.Request] = {}
        streams = {}
        refused = {}

        def send(r):
            requests[r.rid] = r
            stamps[r.rid] = []
            budgets[r.rid] = r.max_new
            try:
                streams[r.rid] = engine.submit(r.prompt, r.max_new,
                                               request_id=r.rid)
            except UnavailableError as e:  # a refusal counts as a failure
                refused[r.rid] = repr(e)

        if mix["kind"] == "open_loop":
            source = traffic.open_loop(mix, run.seed, mix["preroll_s"]
                                       + run.seconds + mix["grace_s"])
        else:
            source = traffic.ClosedLoop(mix, run.seed)
        line = _Timeline(run, engine, mix, time.perf_counter())
        if run.trace:
            tick = pool.step

            def step():
                line.between_ticks()
                return tick()

            pool.step = step
        if mix["kind"] == "open_loop":
            counted, lateness = _open_loop(
                run, mix, source, line, send, streams, refused)
        else:
            counted, lateness = _closed_loop(mix, source, line, send,
                                             finished)
        run.window_end(line.t1)
        prefix1 = engine.prefix_stats()
        steps1 = pool.decode_steps_total
        events = []
        if tracer is not None:
            engine.stop_trace()
            events = [(e.ts, e.name, e.rid, e.dur_s, e.meta)
                      for e in tracer.recorder.snapshot()]
    finally:
        engine.shutdown(drain=False)
    compiles = int(engine.compile_counts() != keys)
    statuses = {rid: s.status for rid, s in streams.items()}
    rec = _serving_record(run, mix, requests, stamps, statuses, counted,
                          refused, line)
    rec["compiles_in_window"] = compiles
    rec["lateness_ms"] = lateness
    rec["layer"].update(
        events=events, prefix=(line.prefix0, prefix1),
        decode_steps=(line.steps0, steps1),
        stretch_bounds=line.bounds, stretch_steps=line.steps)
    rec["stretch"] = line.stretch
    run.read_memory()
    del engine, pool, model, streams, delivered
    gc.collect()
    if str(dev).startswith("cuda"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    gap, controls = _check_served(run, mix, requests, statuses, counted)
    rec["numbers"] = {"served_gap": gap, "short_requests": rec.pop("short")}
    rec["controls"] = controls
    return rec


def _open_loop(run, mix, schedule, line, send, streams, refused):
    """Submits every request at its due time (from the pre-roll's start);
    the window's are those due while it is open.  Past the window it
    keeps the load up until each of them has ended or ``grace_s`` has
    passed.  Returns (the counted ids, lateness ms)."""
    t_begin = line.t0 - mix["preroll_s"]
    counted = [r.rid for r in schedule
               if line.t0 <= t_begin + r.due < line.t1]
    open_ids = set(counted)
    give_up = line.t1 + mix["grace_s"]
    late = []

    def settled(now):
        for rid in list(open_ids):
            s = streams.get(rid)
            if rid in refused or (s is not None and s.done()):
                open_ids.discard(rid)
        return not open_ids or now >= give_up

    def done(now):
        return now >= line.t1 and settled(now) and not line.busy

    for r in schedule:
        due = t_begin + r.due
        while True:
            now = time.perf_counter()
            line.poll(now)
            if now >= due or done(now):
                break
            time.sleep(min(min(due, line.next_event()) - now, 0.05))
        if done(time.perf_counter()):
            break
        late.append((time.perf_counter() - due) * 1e3)
        send(r)
    while not settled(time.perf_counter()) or line.busy:
        line.poll(time.perf_counter())
        time.sleep(0.005)
    return counted, late


def _closed_loop(mix, loop, line, send, finished):
    """``clients`` callers, each sending its next request when its last
    one has delivered its last token, from the pre-roll's start until the
    window closes (and a traced run's stretch after it has been
    recorded); the window's are those sent while it is open."""
    counted = []

    def next_request():
        r = loop.next()
        if line.t0 <= time.perf_counter() < line.t1:
            counted.append(r.rid)
        send(r)

    for _ in range(mix["clients"]):
        next_request()
    while True:
        now = time.perf_counter()
        line.poll(now)
        if now >= line.t1 and not line.busy:
            break
        try:
            finished.get(timeout=max(0.0, min(line.t1, line.next_event())
                                     - now) if now < line.t1 else 0.01)
        except queue.Empty:
            continue
        next_request()
    return counted, []


def _p95(values: List[float]) -> float:
    return float(np.percentile(np.asarray(values, np.float64), 95))


def _serving_record(run, mix, requests, stamps, statuses, counted, refused,
                    line):
    t0 = line.t0
    done, failed, short = [], 0, 0
    for rid in counted:
        st = statuses.get(rid)
        full = st is not None and st.state == "DONE"
        if full and len(st.tokens) != requests[rid].max_new:
            short += 1
        if full:
            done.append(rid)
        elif mix["kind"] == "open_loop" or rid in refused \
                or st is None or st.state not in ("CANCELLED", "DONE"):
            failed += 1
    rec = {"attempted": len(counted), "failed": failed, "short": short,
           "done": done}
    if mix["kind"] == "open_loop":
        itl = [(b[0] - a[0]) * 1e3 for rid in counted
               for a, b in zip(stamps[rid], stamps[rid][1:])]
        rec["e2e"] = {"itl_p95_ms": _p95(itl)}
    else:
        t1 = t0 + run.seconds
        n = sum(1 for seen in stamps.values() for t, _ in seen
                if t0 <= t < t1)
        rec["e2e"] = {"serve_tokens_per_s": n / run.seconds}
    rec["layer"] = {"cfg": run.cfg, "mix": mix, "t0": t0,
                    "t1": t0 + run.seconds, "stamps": stamps,
                    "requests": {rid: (len(r.prompt), r.due, r.group)
                                 for rid, r in requests.items()},
                    "counted": counted}
    return rec


def _check_served(run, mix, requests, statuses, counted):
    """(The widest gap of a served token below the reference's best, over
    ``check_requests`` finished requests: the longest, and the rest drawn
    from the seed; the controls' readings and the tokens checked).  With
    ``run.controls`` the control's widest gap on the same tokens: that of
    the token the reference computed with TF32 puts first."""
    done = [rid for rid in counted if statuses.get(rid) is not None
            and statuses[rid].state == "DONE"]
    if not done:
        return None, {}
    size = {rid: len(requests[rid].prompt) + requests[rid].max_new
            for rid in done}
    longest = max(done, key=lambda rid: (size[rid], rid))
    rest = sorted(set(done) - {longest})
    rng = traffic.rng_for(run.seed, "check")
    pick = [longest] + [rest[i] for i in rng.permutation(len(rest))[
        :mix["check_requests"] - 1]]
    P = weights.make_all(run.cfg, run.seed, run.device)
    widest, control, checked = 0.0, 0.0, 0
    for rid in pick:
        prompt = torch.from_numpy(np.asarray(requests[rid].prompt,
                                             np.int64)).to(run.device)
        toks = torch.as_tensor(np.asarray(statuses[rid].tokens, np.int64),
                               device=run.device)
        checked += len(toks)
        widest = max(widest, float(served_gaps(P, run.cfg, prompt,
                                               toks).max()))
        if run.controls:  # the reference with TF32 in the program's place
            control = max(control, float(served_gaps(
                P, run.cfg, prompt, toks, control=True).max()))
    controls = {"tf32": {"served_gap": control}} if run.controls else {}
    controls["checked_tokens"] = checked
    return widest, controls
