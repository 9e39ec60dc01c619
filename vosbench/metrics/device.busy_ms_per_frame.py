"""device.busy_ms_per_frame: the device's busy time in the traced
sub-window (the union of its kernels, copies and memsets) over the frames
served in it, in ms. Unlike device.idle_pct it does not move with the
host's speed, which the profiler lowers."""


def read(run):
    frames = run.traced()
    if run.trace is None or not frames:
        return None
    return 1e3 * run.trace.busy_s / len(frames)
