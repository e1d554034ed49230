"""What the serving readers share: the engine's tick spans, the tokens
each tick and each decode step delivered, and the work they stand for."""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

import cost


def ticks(layer, outside_stretch: bool = True) -> List[Tuple[float, float]]:
    """(start, end) of the engine's ticks that began in the window, on
    the host clock, leaving out those that overlap the profiled stretch
    and the profiler's collection after it."""
    t0, t1 = layer["t0"], layer["t1"]
    b = layer.get("stretch_bounds") or {}
    held = (b["held_from"], b["released"]) if "released" in b else None
    out = []
    for ts, name, _, dur, _ in layer.get("events", ()):
        if name != "tick" or dur is None or not t0 <= ts <= t1:
            continue
        a, end = ts, ts + dur
        if outside_stretch and held and a < held[1] and end > held[0]:
            continue
        out.append((a, end))
    return sorted(out)


def _inside(spans, t) -> bool:
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= t <= spans[i][1]


def tick_work(layer, spans) -> Tuple[float, float]:
    """(model FLOPs, wall seconds) of the ticks in ``spans``: each decoded
    token one position over its context with the head; each prompt chunk
    its positions over their contexts, the head on a prompt's last."""
    cfg = layer["cfg"]
    reqs = layer["requests"]
    positions = keys = heads = 0
    for rid, seen in layer["stamps"].items():
        plen = reqs[rid][0]
        for i, (t, _) in enumerate(seen):
            if i >= 1 and _inside(spans, t):
                positions += 1
                keys += plen + i
                heads += 1
    for ts, name, _, dur, meta in layer.get("events", ()):
        if name != "tick.prefill" or not meta or not _inside(spans, ts):
            continue
        n, pos = meta["chunk_tokens"], meta["pos"]
        positions += n
        keys += n * pos + n * (n + 1) // 2
        heads += int(pos + n == meta["prompt_tokens"])
    wall = sum(b - a for a, b in spans)
    return cost.forward_flops(cfg, positions, keys, heads), wall


def rows_by_step(layer) -> Dict[int, List[Tuple[int, int]]]:
    """decode step id -> [(context keys, prefix group)] of its rows."""
    out = defaultdict(list)
    reqs = layer["requests"]
    for rid, seen in layer["stamps"].items():
        plen, _, group = reqs[rid]
        for i, (_, step) in enumerate(seen):
            if i >= 1:
                out[step].append((plen + i, group))
    return out


def k1_bound_s(layer, step_ids) -> float:
    """Roofline seconds of the decode attention of ``step_ids``: each
    distinct K/V position read once (a shared prefix once a step)."""
    cfg = layer["cfg"]
    prefix = layer["mix"].get("prefix_len", 0)
    rows = rows_by_step(layer)
    total = 0.0
    for s in step_ids:
        r = rows.get(s, [])
        groups = {g for _, g in r if g >= 0}
        own = [k - prefix if g >= 0 else k for k, g in r]
        b = cost.k1_step_bytes(cfg, own, prefix * len(groups),
                               layer["mix"]["engine"]["cache_dtype"])
        f = cost.k1_step_flops(cfg, sum(k for k, _ in r))
        total += cost.roofline_s(f, b, cost.FP32_CUDA_CORE_FLOPS)
    return total
