"""``device_idle_share.batch``: the share of the profiled stretch (its
length on the host's clock) with no device operation running."""


def read(layer):
    tr, b = layer.get("trace"), layer.get("stretch_bounds")
    if tr is None or not tr.device or not b or "stop" not in b:
        return None
    wall = (b["stop"] - b["start"]) * 1e6
    busy = tr.busy_us(tr.span_us())
    return None if wall <= 0 else 100.0 * max(0.0, 1.0 - busy / wall)
