"""``k1_roofline``: the roofline time of the decode attention that the
live contexts of the decode steps run wholly inside the profiled stretch
need (each distinct K/V byte once: a prefix block several rows share
counts once) over the device time of the kernels that
``kernels/<metric>/`` names in the stretch."""
from harness import servestats


def read(layer):
    tr, steps = layer.get("trace"), layer.get("stretch_steps")
    if tr is None or not steps or steps[1] is None:
        return None
    t = tr.kernel_us(layer["kernels"][layer["metric"]]) / 1e6
    ids = range(steps[0] + 2, steps[1] + 1)
    if t <= 0 or not len(ids):
        return None
    return 100.0 * servestats.k1_bound_s(layer, ids) / t
