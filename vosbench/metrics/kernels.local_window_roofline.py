"""kernels.local_window_roofline: the least time of the traced frames'
short-term local reads (vosbench/work.py `local_window`) over the device
time of the kernels that ops/local_window.*.json name, in %."""


def read(run):
    return run.op_roofline("local_window")
