"""model.mfu: the model's operations on the frames served in the window
before the profiler started (the reference's count on 'meta', attention
at live keys and in-image window slots only; vosbench/work.py) over those
frames' seconds, as a share of the card's peak for the configuration's
precision."""

from vosbench import work


def read(run):
    frames = run.before_trace()
    seconds = run.before_trace_seconds()
    if not frames or seconds <= 0:
        return None
    flops = sum(run.frame_work(f)[0] for f in frames)
    peak = work.PEAK_FLOPS[run.cell.config["precision"]]
    return 100.0 * flops / seconds / peak
