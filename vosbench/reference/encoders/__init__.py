"""The reference's encoders, one file a published `MODEL_ENCODER`: each
exports `encode(P, x, ops) -> [x4, x8, x16, x16]` over the normalised
NCHW image, reading its weights by the published state-dict names. An
attention read of the encoder's own goes through `ops.read` with its
declaration (`model.Read`), so that vosbench/work.py can count it."""
