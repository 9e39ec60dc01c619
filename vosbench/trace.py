"""Reading the profiled sub-window of a traced run.

torch.profiler records the device's activity (CUDA only: recording every
host operation as well would slow the host several-fold) over a few
frames of the window. Its Chrome trace is written to a temporary file
under TMPDIR, read here and deleted. The trace's clock is the host's wall
clock in microseconds (`ts` from `baseTimeNanoseconds`), the clock on
which the harness records the sub-window's span and its own phases
(upload, step, readback, video_switch). From it:

- the device's operations: kernels, copies and memsets, each (name,
  start, end, correlation), inside the sub-window;
- the host's launches (the runtime's and the driver's launch events), each
  a correlation and its start, which tie an operation to the moment the
  host launched it (vosbench/stages.py places it under the program's span
  open then);
- the device's busy time: the union of those intervals, so operations
  that overlap count once;
- the idle gaps, each labelled by the harness phase the host was in when
  the gap began.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Trace:
    def __init__(self, events: List[Dict], base_us: float,
                 window: Tuple[float, float],
                 phases: Sequence[Tuple[str, float, float]]):
        """events: the Chrome trace's; base_us: its time origin on the wall
        clock; window and phases: on the wall clock, in microseconds."""
        self.window = window
        self.phases = sorted(phases, key=lambda p: p[1])
        lo, hi = window
        # (cat, name, start, end, correlation or None)
        self.ops: List[Tuple[str, str, float, float, Optional[int]]] = []
        self.launches: Dict[int, float] = {}   # correlation -> launch start
        for e in events:
            if e.get("ph") != "X":
                continue
            corr = (e.get("args") or {}).get("correlation")
            start = base_us + float(e["ts"])
            if e.get("cat") in LAUNCH_CATS:
                if corr is not None:
                    self.launches[corr] = start
            elif e.get("cat") in DEVICE_CATS:
                end = start + float(e.get("dur", 0.0))
                if end > lo and start < hi:
                    self.ops.append((e["cat"], e.get("name", ""), start, end,
                                     corr))

    @classmethod
    def from_profiler(cls, prof, window, phases) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json", prefix="vosbench-trace-")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.remove(path)
        base_us = float(data.get("baseTimeNanoseconds", 0)) / 1e3
        return cls(data["traceEvents"], base_us, window, phases)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def kernels(self) -> List[Tuple[str, float, float]]:
        return [(n, s, e) for c, n, s, e, _ in self.ops if c == "kernel"]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of device operations, clipped to the sub-window."""
        lo, hi = self.window
        merged: List[List[float]] = []
        spans = sorted((max(s, lo), min(e, hi)) for _, _, s, e, _ in self.ops)
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def idle_gaps(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        gaps, t = [], lo
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        return gaps

    def phase_at(self, t: float) -> str:
        """The harness phase open on the host at time t ('other' between
        phases: the harness's own bookkeeping)."""
        found = "other"
        for name, s, e in self.phases:
            if s > t:
                break
            if e >= t:
                found = name
        return found

    def device_time_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for _, n, s, e, _ in self.ops:
            out[n] = out.get(n, 0.0) + (e - s) / 1e6
        return out

    def idle_by_phase(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s, e in self.idle_gaps():
            p = self.phase_at(s)
            out[p] = out.get(p, 0.0) + (e - s) / 1e6
        return out

    def matched_seconds(self, patterns) -> float:
        """Device seconds of the kernels whose name holds any pattern."""
        return sum(e - s for n, s, e in self.kernels()
                   if any(p in n for p in patterns)) / 1e6
