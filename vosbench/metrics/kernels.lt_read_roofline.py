"""kernels.lt_read_roofline: the least time of the traced frames'
long-term reads at their live keys (vosbench/work.py `lt_read`) over the
device time of the kernels that ops/lt_read.*.json name, in %. Read only
where every long-term read of the traced frames takes a named kernel."""


def read(run):
    return run.op_roofline("lt_read")
