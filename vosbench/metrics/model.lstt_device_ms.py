"""model.lstt_device_ms: the device time, in ms a traced frame, of the
operations launched under the program's `lstt` span (AOT.lstt_forward:
every block, its reads included). An operation counts for the spans open
when the host launched it (vosbench/stages.py), whenever it ran. None where
the program recorded no spans or never opened this one."""


def read(run):
    return run.stage("lstt", "device_ms")
