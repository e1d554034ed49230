"""One run of one cell: the guards, the runner its traffic names, the
output check, the per-layer readers and the result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its
limit); the last lines of standard error repeat the checks.  Without a
card, with fewer cards than the cell asks for, or with JAX loaded in the
process once the window has closed, the run prints no result and exits
with a code other than 0.
"""
from __future__ import annotations

import argparse
import faulthandler
import json
import os
import sys
import time
from typing import Optional

from harness import manifest

# top-level module names that must never be loaded in a run: the JAX
# reference package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "paddle_tpu")
CACHE_DIR = os.path.join(manifest.BENCH_DIR, ".cache")
# seconds after which a run reports its threads' stacks (a run has 360)
HANG_REPORT_S = 330


def process_start_time() -> float:
    """This process's start on the ``time.time()`` clock (``/proc``: 10 ms
    resolution)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def set_environment() -> None:
    """Kernel caches in fixed directories inside the checkout (the
    program builds its own CUDA libraries into ``paddle_tpu_torch/_build``),
    and no library's JAX path."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose whole top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names
                   if m.split(".", 1)[0] in FORBIDDEN})


class Run:
    """What a runner is handed: the cell, the seed, the window's length
    and the device; it marks the window's start and end and reads the
    memory peak through this object."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device: str, t_process: float, controls: bool = False):
        self.cell, self.seed, self.seconds = cell, int(seed), seconds
        self.trace, self.device, self.controls = trace, device, controls
        self.cfg, self.mix = cell["cfg"], cell["mix"]
        self.t_process = t_process
        self.setup_s: Optional[float] = None
        self.window_s: Optional[float] = None
        self.memory_peak_bytes = 0
        self._t0 = None

    def window_start(self) -> None:
        self.setup_s = time.time() - self.t_process
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return 0.0 if self._t0 is None else time.perf_counter() - self._t0

    def window_end(self, t_perf: float) -> None:
        self.window_s = t_perf - self._t0

    def read_memory(self) -> None:
        import torch

        if self.device.startswith("cuda"):
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())


def runner_for(kind: str):
    from harness import serve

    return {"open_loop": serve.run_serve,
            "closed_loop": serve.run_serve}[kind]


def per_layer(cell: dict, rec: dict) -> dict:
    """Each per-layer metric its reader finds something for."""
    layer = dict(rec["layer"])
    stretch = rec.get("stretch")
    layer["trace"] = None if stretch is None else stretch.trace
    layer["kernels"] = {m["name"]: manifest.kernel_patterns(m["name"])
                        for m in cell["per_layer"]}
    out = {}
    for m in cell["per_layer"]:
        value = manifest.metric_reader(m["name"])(dict(layer,
                                                       metric=m["name"]))
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_process: Optional[float] = None,
             controls: bool = False):
    """One run: (the result object, the checks, what else it read).  With
    ``controls`` it also reads the controls and faults that the limits
    are set from (``tools/calibrate.py``)."""
    from harness.check import judge

    run = Run(cell, seed, seconds, trace, device,
              time.time() if t_process is None else t_process, controls)
    rec = runner_for(cell["mix"]["kind"])(run)
    checks = judge(rec["numbers"], cell["limits"])
    checks.append({"name": "compiles_in_window",
                   "value": rec["compiles_in_window"], "limit": 0,
                   "ok": rec["compiles_in_window"] == 0})
    if trace:
        metrics = per_layer(cell, rec)
    else:
        values = dict(rec["e2e"], setup_s=run.setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    device_info = {"platform": "gpu", "kind": None, "count": 1,
                   "memory_peak_bytes": run.memory_peak_bytes}
    if device.startswith("cuda"):
        import torch

        device_info["kind"] = torch.cuda.get_device_name(0)
    result = {"correct": all(c["ok"] for c in checks),
              "attempted": rec["attempted"], "failed": rec["failed"],
              "metrics": metrics, "device": device_info}
    stretch = rec.get("stretch")
    if trace and stretch is not None and stretch.trace is not None:
        tr = stretch.trace
        span = _stretch_us(rec, tr)
        device_info["busy_s"] = tr.busy_us(span) / 1e6
        device_info["window_s"] = (span[1] - span[0]) / 1e6
        result["breakdown"] = tr.breakdown(span)
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    b = rec["layer"].get("stretch_bounds") or {}
    info = {"setup_s": run.setup_s, "window_s": run.window_s,
            "profiler_hold_s": None if "released" not in b else (
                b["prepared"] - b["held_from"], b["released"] - b["stop"]),
            "lateness_ms": rec.get("lateness_ms"),
            "controls": rec.get("controls", {}), "record": rec,
            "numbers": rec["numbers"]}
    return result, checks, info


def _stretch_us(rec, tr):
    """The traced window: the stretch the profiler ran (its length on the
    host's clock, from the trace's first event)."""
    b = rec["layer"].get("stretch_bounds") or {}
    lo, hi = tr.span_us()
    if "stop" in b:
        hi = lo + (b["stop"] - b["start"]) * 1e6
    return lo, hi


def _lateness_line(late) -> str:
    if not late:
        return "generator lateness: none (closed loop)"
    import numpy as np

    a = np.asarray(late)
    return ("generator lateness ms: p50 %.3f p99 %.3f max %.3f over %d "
            "requests" % (np.percentile(a, 50), np.percentile(a, 99),
                          a.max(), a.size))


def main(argv=None) -> int:
    t_process = process_start_time()
    # a run that has not ended by then prints every thread's stack to
    # standard error, so a hang shows where it waits
    faulthandler.dump_traceback_later(HANG_REPORT_S, exit=False)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment()
    cell = manifest.cell(manifest.load_manifest(), args.workload)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print("no result: the cell needs %d CUDA card(s), this machine has "
              "%d" % (cell["chips"], torch.cuda.device_count()
                      if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    result, checks, info = run_cell(cell, args.seed, args.seconds,
                                    bool(args.trace), "cuda", t_process)
    found = forbidden_modules()
    if found:
        print("no result: the run loaded %s" % ", ".join(found),
              file=sys.stderr)
        return 3
    print("setup_s %.3f window_s %.3f" % (info["setup_s"], info["window_s"]),
          file=sys.stderr)
    print(_lateness_line(info["lateness_ms"]), file=sys.stderr)
    if info["profiler_hold_s"] is not None:
        print("the profiler held the process %.3f s starting and %.3f s "
              "stopping" % info["profiler_hold_s"], file=sys.stderr)
    print("readings %s" % json.dumps(info["numbers"], sort_keys=True),
          file=sys.stderr)
    for c in checks:
        print("check %s %s limit %s%s" % (c["name"], c["value"], c["limit"],
                                          "" if c["ok"] else "  FAILED"),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    faulthandler.cancel_dump_traceback_later()
    return 0
