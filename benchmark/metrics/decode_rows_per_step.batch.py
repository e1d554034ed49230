"""``decode_rows_per_step.batch``: tokens decoded in the window (every
token but a request's first, which its last prompt chunk gives) over the
growth of the pool's ``decode_steps_total``."""


def read(layer):
    s = layer.get("decode_steps")
    if not s or s[1] <= s[0]:
        return None
    t0, t1 = layer["t0"], layer["t1"]
    n = sum(1 for seen in layer["stamps"].values()
            for i, (t, _) in enumerate(seen) if i >= 1 and t0 <= t < t1)
    return n / (s[1] - s[0])
