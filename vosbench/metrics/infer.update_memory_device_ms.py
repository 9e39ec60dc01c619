"""infer.update_memory_device_ms: the device time, in ms a traced frame, of
the operations launched under the program's `update_memory` span
(VOSEngine.update_memory, its long-term writes included). An operation
counts for the spans open when the host launched it (vosbench/stages.py),
whenever it ran. None where the program recorded no spans or never opened
this one."""


def read(run):
    return run.stage("update_memory", "device_ms")
