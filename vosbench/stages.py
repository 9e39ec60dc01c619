"""Where a cell's frames spend their time, stage by stage: the program's
own spans (`aot_tpu_torch.utils.tracing`) put on the device trace's
clock.

`Stages` places the traced sub-window's device operations, launches and
idle gaps under the program's spans. Every traced run of the benchmark
builds one (`harness.RunRecord.stages`): the per-layer readers
`metrics/<name>.py` read its table, and the result's `breakdown` gives its
stages, its idle time by span and the program's counters.

By hand, beside the benchmark:

    python3 vosbench/stages.py --workload <cell> --seed <n> [--out FILE]

One process runs the cell's set-up as `run.py` does (`harness.setup`),
then

1. `--cost-frames` frames with spans off and on in turns, a frame each,
   no profiler: the median host time of `step` (call to return) each
   way, and the host's cost of one span off and on, timed alone;
2. the traced frames, as a traced run takes them
   (`harness.profile_frames`).

Its last line of standard output is one JSON object (also written to
`--out`): per span name and traced frame, the kernels launched and their
device time under it (`launches`, `device_ms`: the span and everything
below it; `self_launches`, `self_device_ms`: where it is the innermost open
span), its host self time (`host_self_ms`: its duration less its
children's) and the device's idle time in gaps that began while it was
innermost (`idle_ms`); the idle gaps by innermost span or, outside every
span, by the harness phase (`idle_by_span`); each innermost span's
largest device operations (`ops_by_span`); the counters a frame; and how
each device operation was placed (`join`).

A device operation goes to the span that was innermost on the host when
its launch ran: the trace's `cuda_runtime` and `cuda_driver` events carry
the host time of each launch, and `args.correlation` ties a kernel, copy
or memset to its launch (`trace.Trace.launches`). So a kernel counts for
the stage that launched it, whenever it ran on the device. An operation
whose launch the trace lacks is placed by the host's span at the moment it
started on the device (`join.by_start`), which is right only where the
host waits for the device. Outside every span an operation goes to the
harness phase open at its launch (upload, step, readback, video_switch, or
other).
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

CHECKOUT = Path(__file__).resolve().parent.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from vosbench.trace import Trace  # noqa: E402

SPAN_TIMING_CALLS = 100_000


def self_ns(spans) -> List[int]:
    """Each closed span's duration less the time its children cover (the
    children of one span nest on one thread and never overlap). The
    yardstick's own arithmetic: the benchmark takes only the program's
    records, not its `tracing.self_ns`."""
    own = [(s.end_ns - s.start_ns) if s.end_ns is not None else 0
           for s in spans]
    for s in spans:
        if s.parent >= 0 and s.end_ns is not None:
            own[s.parent] -= s.end_ns - s.start_ns
    return own


class Stages:
    """The traced sub-window's device operations, launches and idle gaps
    placed under the program's spans.

    trace: the sub-window's (trace.Trace, with its launches); spans: the
    program's `tracing.take_spans()` records (wall clock, ns), the
    lead-in frames' included; frames: the traced frames."""

    def __init__(self, trace: Trace, spans, frames: int):
        self.trace = trace
        self.frames = frames
        self.spans = list(spans)
        lo, hi = trace.window
        launch_at = trace.launches
        ops = sorted((start, end, cat, corr, name)
                     for cat, name, start, end, corr in trace.ops)
        self._segments()
        self.by_launch = self.by_start = 0
        # per op: (exclusive device seconds, is a kernel, label, name) where
        # the label is a span index, or a harness phase's name
        self.placed: List[Tuple[float, bool, object, str]] = []
        covered = lo
        for start, end, cat, corr, name in ops:
            own = max(0.0, min(end, hi) - max(start, lo, covered)) / 1e6
            covered = max(covered, min(end, hi))
            t = launch_at.get(corr)
            if t is None:
                t = start
                self.by_start += 1
            else:
                self.by_launch += 1
            self.placed.append((own, cat == "kernel", self.label_at(t),
                                name))

    def _segments(self) -> None:
        """The innermost open span over time, as sorted breakpoints: from
        self._at[i] on, self._inner[i] (a span index, or -1) is innermost
        until the next breakpoint."""
        edges = []
        for i, s in enumerate(self.spans):
            if s.end_ns is None:
                continue
            edges.append((s.start_ns / 1e3, 1, i))
            edges.append((s.end_ns / 1e3, 0, i))
        # ends before starts at one instant; a parent opens before its child
        edges.sort(key=lambda x: (x[0], x[1], x[2] if x[1] else -x[2]))
        stack: List[int] = []
        self._at: List[float] = []
        self._inner: List[int] = []
        for t, opening, i in edges:
            if opening:
                stack.append(i)
            elif i in stack:
                stack.remove(i)
            self._at.append(t)
            self._inner.append(stack[-1] if stack else -1)

    def innermost(self, t: float) -> int:
        """The index of the innermost span open at wall-clock time t (us),
        or -1."""
        k = bisect.bisect_right(self._at, t) - 1
        return self._inner[k] if k >= 0 else -1

    def label_at(self, t: float):
        i = self.innermost(t)
        return i if i >= 0 else self.trace.phase_at(t)

    def chain(self, i: int) -> List[str]:
        """The names of span i and of every span enclosing it, each once."""
        names = []
        while i >= 0:
            if self.spans[i].name not in names:
                names.append(self.spans[i].name)
            i = self.spans[i].parent
        return names

    def table(self) -> Optional[Dict[str, Dict[str, float]]]:
        """Per span name, per frame: launches, device_ms, self_launches,
        self_device_ms, host_self_ms, idle_ms. None where no span was
        recorded."""
        if not self.spans or self.frames <= 0:
            return None
        keys = ("launches", "device_ms", "self_launches", "self_device_ms",
                "host_self_ms", "idle_ms")
        out: Dict[str, Dict[str, float]] = {}

        def row(name):
            return out.setdefault(name, dict.fromkeys(keys, 0.0))

        for own, kernel, label, _ in self.placed:
            if isinstance(label, str):
                continue
            r = row(self.spans[label].name)
            r["self_device_ms"] += own * 1e3
            r["self_launches"] += kernel
            for name in self.chain(label):
                row(name)["device_ms"] += own * 1e3
                row(name)["launches"] += kernel
        lo, hi = self.trace.window
        for s, own in zip(self.spans, self_ns(self.spans)):
            if s.end_ns is not None and lo <= s.start_ns / 1e3 < hi:
                row(s.name)["host_self_ms"] += own / 1e6
        for s, e in self.trace.idle_gaps():
            i = self.innermost(s)
            if i >= 0:
                row(self.spans[i].name)["idle_ms"] += (e - s) / 1e3
        return {name: {k: v / self.frames for k, v in r.items()}
                for name, r in sorted(out.items())}

    def idle_by_span(self) -> Dict[str, float]:
        """Idle seconds by the innermost span at a gap's start, or by the
        harness phase ('phase:<name>') outside every span."""
        out: Dict[str, float] = {}
        for s, e in self.trace.idle_gaps():
            label = self.label_at(s)
            key = (self.spans[label].name if not isinstance(label, str)
                   else f"phase:{label}")
            out[key] = out.get(key, 0.0) + (e - s) / 1e6
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def outside_spans(self) -> Dict[str, float]:
        """Device seconds placed under no span, by the harness phase."""
        out: Dict[str, float] = {}
        for own, _, label, _ in self.placed:
            if isinstance(label, str):
                out[label] = out.get(label, 0.0) + own
        return out

    def ops_by_span(self, top: int = 8) -> Dict[str, List[list]]:
        """Per innermost span name (or 'phase:<name>'), its `top` device
        operations by device time: [name, ms a frame, launches a frame]."""
        by: Dict[str, Dict[str, List[float]]] = {}
        for own, _, label, name in self.placed:
            key = (f"phase:{label}" if isinstance(label, str)
                   else self.spans[label].name)
            acc = by.setdefault(key, {}).setdefault(name, [0.0, 0])
            acc[0] += own
            acc[1] += 1
        n = max(self.frames, 1)
        return {key: [[name[:100], s * 1e3 / n, c / n] for name, (s, c) in
                      sorted(ops.items(), key=lambda kv: -kv[1][0])[:top]]
                for key, ops in sorted(by.items())}

    def kernel_share(self, phases: Sequence[str] = ("readback",)) -> float:
        """The share of the kernels' device time placed under a span or
        under one of `phases`."""
        total = sum(own for own, kernel, _, _ in self.placed if kernel)
        kept = sum(own for own, kernel, label, _ in self.placed
                   if kernel and (not isinstance(label, str)
                                  or label in phases))
        return kept / total if total > 0 else 0.0


def span_cost_ns(calls: int = SPAN_TIMING_CALLS) -> Dict[str, float]:
    """The host's cost of one `with span(...)`, off and on, timed alone."""
    from aot_tpu_torch.utils import tracing

    out = {}
    for on in (False, True):
        prev = tracing.enable_spans(on)
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            with tracing.span("cost"):
                pass
        out["on" if on else "off"] = (time.perf_counter_ns() - t0) / calls
        tracing.enable_spans(prev)
        tracing.take_spans()
    return out


def measure(cell, seed: int, device, cost_frames: int) -> Dict:
    """One process's measurement of `cell` (harness.Cell) on `device`."""
    import gc

    import torch

    from vosbench import harness

    tracing = harness.program_tracing()
    device = torch.device(device)
    run = harness.setup(cell, seed, device)
    setup_counters = tracing.counters()
    gc.collect()
    gc.freeze()
    gc.disable()
    enqueue = {False: [], True: []}
    spans_a_frame = []
    for i in range(cost_frames):
        on = bool(i % 2)
        prev = tracing.enable_spans(on)
        rec = run.runner.run(*next(run.frames), window=True)
        tracing.enable_spans(prev)
        made = len(tracing.take_spans())
        if rec.kind == "step":
            enqueue[on].append(rec.enqueue)
            if on:
                spans_a_frame.append(made)
    profiled = harness.profile_frames(run.runner, run.frames,
                                      cell.workload["trace_frames"], device,
                                      tracing)
    harness.synchronize(device)
    gc.enable()
    gc.unfreeze()
    trace, st = profiled.read(run.runner.phases)
    n = profiled.frames
    off, on = (statistics.median(enqueue[k]) * 1e3 if enqueue[k] else None
               for k in (False, True))
    run.server.close()
    return {
        "workload": cell.name, "seed": seed,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "frames": n,
        "join": {"by_launch": st.by_launch, "by_start": st.by_start},
        "kernel_share_under_spans_or_readback": st.kernel_share(),
        "launches_per_frame": len(trace.kernels()) / n,
        "busy_ms_per_frame": trace.busy_s * 1e3 / n,
        "window_s": trace.window_s,
        "stages": st.table(),
        "idle_by_span": st.idle_by_span(),
        "ops_by_span": st.ops_by_span(),
        "device_s_outside_spans": st.outside_spans(),
        "counters": {k: v / n for k, v in profiled.counters.items()},
        "setup_counters": setup_counters,
        "cost": {"enqueue_ms_spans_off": off, "enqueue_ms_spans_on": on,
                 "frames_each": [len(enqueue[False]), len(enqueue[True])],
                 "spans_a_frame": (statistics.median(spans_a_frame)
                                   if spans_a_frame else None),
                 "span_ns": span_cost_ns()},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--cost-frames", type=int, default=400,
                   help="frames of the spans' cost measurement (0: none)")
    p.add_argument("--out", help="also write the JSON object here")
    args = p.parse_args(argv)
    import torch

    from vosbench import harness

    if not torch.cuda.is_available():
        print("vosbench stages: needs a CUDA card", file=sys.stderr)
        return 2
    if harness.program_tracing() is None:
        print("vosbench stages: the program has no spans "
              "(aot_tpu_torch.utils.tracing)", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    cell = harness.load_cell(CHECKOUT / "BENCHMARK.json", args.workload)
    out = measure(cell, args.seed, "cuda:0", args.cost_frames)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
