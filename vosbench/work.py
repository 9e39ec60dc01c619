"""The yardstick's arithmetic: the card's peaks, the least time of an
attention read, and the model's operations a frame.

Peaks (NVIDIA's H100 SXM data sheet, dense): fp32 work runs at most at
495 / 3 TFLOP/s, the TF32 tensor-core rate over the three products that
fp32 accuracy takes (3xTF32), which is above the 67 TFLOP/s of the fp32
units, so no fp32 kernel can read above its bound; bf16 at 989 TFLOP/s;
HBM3 at 3.35 TB/s.

A read's least time is the larger of its operations over the peak rate and
its bytes (each input read once, each output written once) over the
bandwidth. An attention read counts only live keys and in-image window
slots, whatever route the program takes for it.

The model's operations a frame are counted by running the cell's reference
(reference.load(root)) on the 'meta' device (shapes only) under torch's
FLOP counter, with the attention reads replaced by a stand-in that records
their shapes and counts each read's operations once, by its own work
function: `global_work` and `local_work` for the model's two reads, the
`work` of its declaration (reference/model.py `Read`) for a read an
encoder declares.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from vosbench import reference

ROOT = Path(__file__).resolve().parent
MAX_DIS = 7       # the published local window's radius (15 x 15 slots)
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, dtype: str = "float32") -> float:
    """The least seconds the card could take for this work."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def window_slots(hgt: int, wid: int, max_dis: int = MAX_DIS) -> float:
    """(query, window slot) pairs whose slot lies inside the image."""
    r = np.arange(-max_dis, max_dis + 1)
    rows = ((np.arange(hgt)[:, None] + r >= 0)
            & (np.arange(hgt)[:, None] + r < hgt)).sum()
    cols = ((np.arange(wid)[:, None] + r >= 0)
            & (np.arange(wid)[:, None] + r < wid)).sum()
    return float(rows) * float(cols)


def local_work(b, hgt, wid, h, d, dv, with_rv: bool, elem: int = 4):
    """(flops, bytes) of a local-window read: per head and in-image slot,
    2d for q.k and 2dv for p.v (2dv more for p.rel_v); q, k, v, the
    relative key bias (fp32) and rel_v read once, out written once."""
    slots = window_slots(hgt, wid)
    flops = b * h * slots * (2 * d + 2 * dv * (2 if with_rv else 1))
    win2 = (2 * MAX_DIS + 1) ** 2
    hw = hgt * wid
    nbytes = (elem * b * hw * h * (2 * d + 2 * dv)
              + 4 * (b * h * hw * win2 + (h * dv * win2 if with_rv else 0)))
    return flops, nbytes


def global_work(lq, live, h, d, dv, elem: int = 4):
    """(flops, bytes) of attention over `live` keys: 2(d + dv) a (query,
    live key, head); q, the live k and v read once, out and the row
    log-sum-exp (fp32) written once."""
    flops = 2.0 * h * lq * live * (d + dv)
    nbytes = elem * (lq * h * (d + dv) + live * h * (d + dv)) + 4 * h * lq
    return flops, nbytes


class CountingOps:
    """Stands in for the reference's attention reads: records each read's
    shape. The model's two reads return zeros of the right shape (no work
    on 'meta'); a declared read runs its plain version on 'meta', and the
    operations the FLOP counter gives that run are kept in `plain_flops`,
    for frame_work to take back out."""

    def __init__(self):
        self.reads: List[Tuple] = []
        self.plain_flops = 0
        self.counter = None      # the FLOP counter the reads run under

    def clear(self) -> None:
        self.reads.clear()
        self.plain_flops = 0

    def global_read(self, q, k, v, heads, d, role=""):
        b, lq, _ = q.shape
        dv = v.shape[-1] // heads
        self.reads.append(("global", role, b, lq, k.shape[1], heads, d, dv))
        return q.new_zeros((b, lq, v.shape[-1]))

    def local_read(self, q, k, v, rel_bias, rel_v, heads, size_2d, d):
        b = q.shape[0]
        dv = v.shape[-1] // heads
        self.reads.append(("local", "st", b, size_2d, heads, d, dv,
                           rel_v is not None))
        return q.new_zeros((b, q.shape[1], v.shape[-1]))

    def read(self, decl, *args):
        shapes = tuple(tuple(a.shape) if isinstance(a, torch.Tensor) else a
                       for a in args)
        self.reads.append((decl.name, decl.role, shapes, decl.work))
        before = self.counter.get_total_flops() if self.counter else 0
        out = decl.plain(*args)
        if self.counter:
            self.plain_flops += self.counter.get_total_flops() - before
        return out


def read_work(read) -> Tuple[float, float]:
    """(flops, bytes) of one recorded read: the model's global and local
    reads by global_work and local_work, a declared read (name, role,
    shapes, work) by its own work function."""
    if read[0] == "global":
        _, _, b, lq, live, h, d, dv = read
        f, n = global_work(lq, live, h, d, dv)
        return b * f, b * n
    if read[0] == "local":
        _, _, b, (hgt, wid), h, d, dv, rv = read
        return local_work(b, hgt, wid, h, d, dv, rv)
    _, _, shapes, work = read
    return work(*shapes)


@functools.lru_cache(maxsize=None)
def frame_work(model_key: Tuple, layout: Tuple, size: Tuple[int, int],
               kind: str, live_frames: int, root=ROOT):
    """(flops of the whole frame, the attention reads it makes) for a
    frame of `kind` 'ref' (a video's first frame) or 'step' (a frame read
    against `live_frames` long-term frames), counted on 'meta'. model_key:
    `model_key(cfg)`; layout: ((name, shape), ...) of the weights; root:
    the benchmark folder whose reference counts it (the cell's)."""
    ref = reference.load(root)
    cfg = dict(model_key)
    params = {k: torch.empty(s, device="meta") for k, s in layout}
    ops = CountingOps()
    model = ref.model.Model(params, cfg, ops=ops)
    stream = ref.stream.Stream(model, lt_gap=1 << 30)
    img = torch.empty((1,) + tuple(size) + (3,), dtype=torch.uint8,
                      device="meta")
    mask = torch.empty((1,) + tuple(size), dtype=torch.int64, device="meta")
    with FlopCounterMode(display=False) as counter:
        ops.counter = counter
        stream.reference_frame(img, mask, 1)
    if kind == "step":
        stream.lt = [{k: v.repeat(1, live_frames, 1) for k, v in layer.items()}
                     for layer in stream.lt]
        ops.clear()
        with FlopCounterMode(display=False) as counter:
            ops.counter = counter
            logits = stream.propagate(img)
            model.upsample(logits, size).argmax(dim=1)
            stream.write(mask)
    reads = list(ops.reads)
    flops = (counter.get_total_flops() - ops.plain_flops
             + sum(read_work(r)[0] for r in reads))
    return float(flops), reads


def op_bound_s(reads, role: str) -> float:
    """The least seconds of the reads of `role` ('lt', 'st', or a declared
    read's)."""
    return sum(bound_s(*read_work(r)) for r in reads if r[1] == role)


def model_key(cfg: Dict) -> Tuple:
    keys = ("MODEL_VOS", "MODEL_ENCODER", "MODEL_LSTT_NUM", "MODEL_ATT_HEADS",
            "MODEL_SELF_HEADS", "MODEL_MAX_OBJ_NUM",
            "MODEL_ENCODER_EMBEDDING_DIM", "MODEL_ALIGN_CORNERS")
    return tuple((k, cfg[k]) for k in keys)


def live_frames_of(engine: Dict, count: int) -> int:
    """LT frames a read sees when `count` have been written."""
    cap = engine.get("TEST_LONG_TERM_MEM_CAP")
    if engine.get("TEST_LONG_TERM_MEM_POLICY") == "fifo" and cap:
        return min(count, cap)
    return count


# the work functions that ops/*.json name by a bare name: least seconds of
# a frame's reads (a file's own is named "<file>.py:<function>", ops/)

def local_window(reads) -> float:
    return op_bound_s(reads, "st")


def lt_read(reads) -> float:
    return op_bound_s(reads, "lt")
