"""model.encode_launches_per_frame: the kernels launched under the program's
`encode` span (VOSEngine.encode_image, the uint8 normalisation included), a
traced frame. An operation counts for the spans open when the host launched
it (vosbench/stages.py), whenever it ran. None where the program recorded
no spans or never opened this one."""


def read(run):
    return run.stage("encode", "launches")
