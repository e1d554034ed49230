"""``device_idle_share.chat``: the share of the engine ticks' wall inside
the profiled stretch with no device operation running."""


def read(layer):
    tr, b = layer.get("trace"), layer.get("stretch_bounds")
    if tr is None or not b or "stop" not in b or not tr.device:
        return None
    lo, hi = b["start"], b["stop"]
    wall = 0.0
    for ts, name, _, dur, _ in layer.get("events", ()):
        if name == "tick" and dur is not None:
            wall += max(0.0, min(ts + dur, hi) - max(ts, lo))
    if wall <= 0:
        return None
    busy = tr.busy_us(tr.span_us()) / 1e6
    return 100.0 * max(0.0, 1.0 - busy / wall)
