"""kernels.swin_window_roofline: the least time of the traced frames' Swin
window reads (ops/swin_window.py: in-image queries and tokens only) over
the device time of the kernels that ops/swin_window.*.json name, in %.
None where none of them ran (a program whose Swin blocks take their plain
path)."""


def read(run):
    return run.op_roofline("swin_window")
