"""The device trace of a profiled stretch: ``torch.profiler`` over CPU and
CUDA, exported as a Chrome trace under ``TMPDIR``, read back and deleted.
Device operations are the kernels, copies and sets; busy time is the
union of their intervals; an idle gap is named by what the host was
doing through it (the innermost host event spanning its middle)."""
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")


class Stretch:
    """One profiled stretch.  ``prepare()`` starts the profiler, in
    set-up, on a schedule that only warms it up (the costly start);
    ``start()`` and ``stop()`` open and close the recording in the
    window; the trace is exported and read at the first use of ``trace``
    (a :class:`Trace`), after the window.  On the card it records the
    device and the CUDA runtime calls only, not every host operation: a
    serving loop's host operations are many, and collecting them stalls
    the process when the recording stops."""

    def __init__(self, device):
        self.on_card = str(device).startswith("cuda")
        self.host = not self.on_card
        self.started = self.stopped = False
        self._trace: Optional[Trace] = None
        self._prof = None

    def prepare(self) -> "Stretch":
        from torch.profiler import ProfilerActivity, profile, schedule

        acts = [ProfilerActivity.CPU] if self.host else []
        if self.on_card:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=lambda p: None)
        self._prof.__enter__()
        return self

    def _step(self):
        import torch

        if self.on_card:
            torch.cuda.synchronize()
        self._prof.step()

    def start(self) -> None:
        self._step()
        self.started = True

    def stop(self) -> None:
        self._step()
        self.stopped = True

    def close(self) -> None:
        """Leave the profiler (after the window)."""
        if self._prof is not None:
            self._prof.__exit__(None, None, None)

    @property
    def trace(self) -> Optional["Trace"]:
        if self._trace is None and self.stopped:
            self.close()
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    self._trace = Trace(json.load(f))
            finally:
                os.remove(path)
            self._prof = None
        return self._trace


def _union(intervals: Sequence[Tuple[float, float]]) -> List[list]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """A Chrome trace's device operations and host events (times in us)."""

    def __init__(self, doc: dict):
        ev = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
        self.device = [(e["name"], float(e["ts"]), float(e.get("dur", 0)))
                       for e in ev if e.get("cat") in DEVICE_CATS]
        self.host = [(e["name"], float(e["ts"]), float(e.get("dur", 0)))
                     for e in ev if e.get("cat") in HOST_CATS]

    def span_us(self) -> Tuple[float, float]:
        """The stretch: from the first to the last event, host or device."""
        pts = [t for _, t, _ in self.device + self.host] + [
            t + d for _, t, d in self.device + self.host]
        return (min(pts), max(pts)) if pts else (0.0, 0.0)

    def busy_intervals(self, within=None) -> List[list]:
        iv = [(t, t + d) for _, t, d in self.device]
        merged = _union(iv)
        if within is None:
            return merged
        lo, hi = within
        return [[max(a, lo), min(b, hi)] for a, b in merged
                if b > lo and a < hi]

    def busy_us(self, within=None) -> float:
        return sum(b - a for a, b in self.busy_intervals(within))

    def kernel_us(self, patterns: Sequence[str]) -> float:
        """Device time of the operations whose name holds a pattern."""
        return sum(d for name, _, d in self.device
                   if any(p in name for p in patterns))

    def breakdown(self, within=None, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by what the host was doing through each: [name, seconds]."""
        ops: Dict[str, float] = {}
        for name, _, d in self.device:
            ops[name] = ops.get(name, 0.0) + d
        lo, hi = within if within is not None else self.span_us()
        busy = self.busy_intervals((lo, hi))
        gaps, prev = [], lo
        for a, b in busy:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if hi > prev:
            gaps.append((prev, hi))
        host = sorted(self.host, key=lambda h: h[1])
        idle: Dict[str, float] = {}
        active: list = []
        i = 0
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = 0.5 * (a + b)
            while i < len(host) and host[i][1] <= mid:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[1] + h[2] >= mid]
            inner = min(active, key=lambda h: h[2], default=None)
            label = "host: no event" if inner is None else inner[0]
            idle[label] = idle.get(label, 0.0) + (b - a)
        return {
            "device_ops": [[n[:120], s / 1e6] for n, s in sorted(
                ops.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[n[:120], s / 1e6] for n, s in sorted(
                idle.items(), key=lambda kv: -kv[1])[:top]],
        }
