"""device.idle_pct: the share of the traced sub-window in which no kernel,
copy or memset runs on the device (the union of their intervals on the
trace's timeline), in %. It is read under the profiler, whose callbacks
slow the host's launches: where the host bounds the frame, it reads higher
than an unprofiled frame's idle share would."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
