"""infer.launches_per_frame: the device's kernels in the traced sub-window
(the profiler's kernel events) over the frames served in it."""


def read(run):
    frames = run.traced()
    if run.trace is None or not frames:
        return None
    return len(run.trace.kernels()) / len(frames)
