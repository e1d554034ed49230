"""``serve_step_mfu``: model FLOPs of the positions the engine's ticks
computed (decoded tokens, and prompt tokens not served from a prefix)
over the ticks' wall, over the fp32 peak at fp32 accuracy (3xTF32); the
ticks that overlap the profiled stretch are left out."""
import cost
from harness import servestats


def read(layer):
    if not layer.get("events"):
        return None
    flops, wall = servestats.tick_work(layer, servestats.ticks(layer))
    return None if wall <= 0 else 100.0 * flops / wall \
        / cost.FP32_3XTF32_FLOPS
