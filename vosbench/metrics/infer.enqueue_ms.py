"""infer.enqueue_ms: the median, over the window's frames served before the
profiler started, of the host's time from the call of
VOSInferEngine.step to its return, with no synchronize in between: the
host's cost of issuing a frame's work. Host clock."""

import statistics


def read(run):
    times = [f.enqueue for f in run.before_trace() if f.kind == "step"]
    return statistics.median(times) * 1e3 if times else None
