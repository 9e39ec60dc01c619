"""model.lt_read_device_ms: the device time, in ms a traced frame, of the
operations launched under the program's `lt_read` spans (each block's
long-term attention, DeAOT's concatenation of its values included). An
operation counts for the spans open when the host launched it
(vosbench/stages.py), whenever it ran. None where the program recorded no
spans or never opened this one."""


def read(run):
    return run.stage("lt_read", "device_ms")
