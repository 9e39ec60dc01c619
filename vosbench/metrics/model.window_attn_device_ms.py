"""model.window_attn_device_ms: the device time, in ms a traced frame, of
the operations launched under the program's `window_attn` spans (each Swin
block's attention, from the qkv Linear to the output projection). An
operation counts for the spans open when the host launched it
(vosbench/stages.py), whenever it ran. None where the program recorded no
spans or never opened this one."""


def read(run):
    return run.stage("window_attn", "device_ms")
