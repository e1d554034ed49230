"""The op profiler, the device trace and step timing (counterpart of the
reference's ``profiler``: paddle's ``fluid/profiler.py``
``start_profiler:222`` / ``stop_profiler:262`` / ``profiler:314``).

While the profiler runs, or while ``FLAGS_benchmark`` is set, every op
installed by ``framework.dispatch`` synchronizes its device after it runs
and records its wall time here (``record_op_time``): accurate time an op,
at the cost of the pipelining, as the reference's flag does.  With
neither on the op pays two reads of a flag.  ``stop_profiler`` returns
(and prints, or writes) the table sorted by the key asked for.

``xla_trace(log_dir)`` keeps the reference's name and writes
``torch.profiler``'s Chrome trace, with CUDA kernels where there is a
card.  ``StepTimer`` gives a step's wall time, items a second and MFU
against ``device_peak_flops()``, the bf16 dense peak of the card by its
data sheet (``None`` for a device not in the table, where ``mfu`` reads
0.0).  The serving engine times each tick with it.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Optional

from ..core.errors import InvalidArgumentError
from ..framework import dispatch as _dispatch
from .visual import LogWriter, export_chrome_tracing  # noqa: F401

__all__ = ["start_profiler", "stop_profiler", "profiler", "xla_trace",
           "StepTimer", "is_profiling", "record_op_time",
           "device_peak_flops", "LogWriter", "export_chrome_tracing"]

_events = defaultdict(lambda: [0, 0.0])  # name -> [count, total_s]

# bf16 dense tensor-core peak FLOP/s by the card's name (data sheets)
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}


def is_profiling() -> bool:
    return _dispatch.op_timing_on()


def record_op_time(name: str, seconds: float) -> None:
    _events[name][0] += 1
    _events[name][1] += seconds


def start_profiler(state: str = "All", tracer_option: str = "Default") -> None:
    """Clear the table and time every installed op from here on."""
    if state not in ("CPU", "GPU", "All"):
        raise InvalidArgumentError(
            "profiler state must be CPU/GPU/All, got %r" % state)
    _events.clear()
    _dispatch.set_op_timing(True)


def stop_profiler(sorted_key: Optional[str] = "total",
                  profile_path: Optional[str] = None) -> str:
    """Stop timing and print (or write to ``profile_path``) the table of
    ops sorted by ``sorted_key``; returns it."""
    keys = {"calls": lambda kv: kv[1][0], "total": lambda kv: kv[1][1],
            "max": lambda kv: kv[1][1], "min": lambda kv: kv[1][1],
            "ave": lambda kv: kv[1][1] / max(kv[1][0], 1), None: lambda kv: 0}
    if sorted_key not in keys:
        raise InvalidArgumentError(
            "sorted_key must be calls/total/ave/max/min/None, got %r"
            % sorted_key)
    _dispatch.set_op_timing(False)
    rows = sorted(_events.items(), key=keys[sorted_key], reverse=True)
    lines = ["%-40s %10s %15s %15s" % ("Event", "Calls", "Total(ms)",
                                       "Ave(ms)")]
    for name, (calls, total) in rows:
        lines.append("%-40s %10d %15.3f %15.3f"
                     % (name, calls, total * 1e3, total / max(calls, 1) * 1e3))
    table = "\n".join(lines)
    if profile_path:
        with open(profile_path, "w") as f:
            f.write(table)
    else:
        print(table)
    return table


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: str = "total",
             profile_path: Optional[str] = None,
             tracer_option: str = "Default"):
    """``start_profiler`` on entry, ``stop_profiler`` on exit."""
    start_profiler(state, tracer_option)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


@contextlib.contextmanager
def xla_trace(log_dir: str):
    """A device trace of the block: ``torch.profiler`` over the CPU and,
    where there is a card, its CUDA kernels, written as a Chrome trace to
    ``<log_dir>/trace.json`` on exit.  Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_peak_flops() -> Optional[float]:
    """The bf16 dense peak FLOP/s of card 0 by its data sheet, or None when
    there is no card or its name is not in :data:`PEAK_BF16_FLOPS`."""
    import torch

    if not torch.cuda.is_available():
        return None
    return PEAK_BF16_FLOPS.get(torch.cuda.get_device_name(0))


class StepTimer:
    """Wall time of the steps timed so far (use it as a context manager
    around each step), items a second and MFU."""

    def __init__(self, flops_per_step: float = 0.0,
                 peak_flops: Optional[float] = None,
                 items_per_step: float = 0.0):
        self.flops_per_step = flops_per_step
        self.items_per_step = items_per_step
        self._peak = peak_flops
        self._t0 = None
        self.steps = 0
        self.total = 0.0

    @property
    def peak_flops(self) -> Optional[float]:
        """The peak MFU divides by: the one given, else the card's."""
        if self._peak is None:
            self._peak = device_peak_flops()
        return self._peak

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total += time.perf_counter() - self._t0
        self.steps += 1

    @property
    def step_time(self) -> float:
        return self.total / max(self.steps, 1)

    @property
    def items_per_sec(self) -> float:
        return self.items_per_step / self.step_time if self.total else 0.0

    @property
    def mfu(self) -> float:
        """Achieved FLOP/s over the peak; 0.0 without flops, time or a
        peak."""
        if not (self.flops_per_step and self.total):
            return 0.0
        peak = self.peak_flops
        if not peak:
            return 0.0
        return self.flops_per_step / self.step_time / peak
