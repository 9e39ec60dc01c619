"""model.encode_device_ms: the device time, in ms a traced frame, of the
operations launched under the program's `encode` span (the encoder). An
operation counts for the spans open when the host launched it
(vosbench/stages.py), whenever it ran. None where the program recorded no
spans or never opened this one."""


def read(run):
    return run.stage("encode", "device_ms")
