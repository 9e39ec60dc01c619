"""The general traffic generator: a cell's workload file names the
parameters, and this module makes its frames and its schedule from the seed.

Frames. A pool of POOL_FRAMES frames of `frame_size` (the size at which
the evaluator hands a frame to the engine) shows as many ellipses of
distinct colours as the cell's largest video has objects, with radii a
fraction ELLIPSE_RADIUS of the frame, bouncing at up to ELLIPSE_SPEED_PX
pixels a frame over a noisy gradient. The pool is drawn on the device in a
few large calls and copied once into host memory (page-locked where there
is a card), as uint8 RGB frames and uint8 label maps; a video plays it
forwards and backwards from a seed-drawn start, so no frame is made inside
the measured window and motion stays continuous.

Schedule. `videos` lists (frames, objects) pairs. One closed-loop stream
plays them in a seed-drawn order, reshuffled each time the list is used
up (a pass). A video's first frame carries its mask: the pool's labels
with every id above the video's objects cleared. The seed changes the
order, the starts and the pixels, never the set of sizes.

Before the window: `warmup_video` (frames, objects), a video of its own,
and then the stream's first `fill_steps` frames after its reference frame.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_CHUNK = 16                    # pool frames drawn at a time
POOL_FRAMES = 256
ELLIPSE_RADIUS = (0.05, 0.12)  # of the frame's height and width
ELLIPSE_SPEED_PX = 6.0


@dataclasses.dataclass
class Video:
    index: int          # position in the stream (-1: the warm-up video)
    frames: int
    objects: int
    start: int         # pool position of the first frame


class Traffic:
    def __init__(self, spec: Dict, seed: int, device):
        self.spec = spec
        self.size = tuple(spec["frame_size"])
        self.rng = np.random.default_rng(seed)
        self.images, self.labels = make_pool(spec, seed, device)

    @property
    def pool(self) -> int:
        return len(self.images)

    def pool_index(self, video: Video, t: int) -> int:
        """The pool frame of frame t of `video`: forwards, then backwards."""
        period = 2 * (self.pool - 1)
        i = (video.start + t) % period
        return i if i < self.pool else period - i

    def image(self, video: Video, t: int) -> torch.Tensor:
        """Frame t of `video`: (H, W, 3) uint8 in host memory."""
        return self.images[self.pool_index(video, t)]

    def mask(self, video: Video) -> np.ndarray:
        """The reference frame's ids, 0..video.objects."""
        lab = self.labels[self.pool_index(video, 0)]
        return np.where(lab <= video.objects, lab, 0).astype(np.uint8)

    def warmup(self) -> Video:
        frames, objects = self.spec["warmup_video"]
        return Video(-1, frames, objects, int(self.rng.integers(self.pool)))

    def first_pass(self, stream: Iterator[Video]):
        """(the stream's first pass, the stream from its start): the pass
        is drawn ahead, in the stream's own order of draws."""
        first = [next(stream) for _ in self.spec["videos"]]
        return first, itertools.chain(first, stream)

    def videos(self) -> Iterator[Video]:
        specs = [tuple(v) for v in self.spec["videos"]]
        index = 0
        while True:
            for j in self.rng.permutation(len(specs)):
                frames, objects = specs[j]
                yield Video(index, frames, objects,
                            int(self.rng.integers(self.pool)))
                index += 1


def _bounce(p: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """Reflect positions into [lo, hi]."""
    span = hi - lo
    q = torch.remainder(p - lo, 2 * span)
    return lo + torch.where(q > span, 2 * span - q, q)


def make_pool(spec: Dict, seed: int, device) -> Tuple[torch.Tensor,
                                                       np.ndarray]:
    """(P, H, W, 3) uint8 frames, a host tensor (page-locked where there is
    a card, so each upload is one direct copy), and (P, H, W) uint8
    labels."""
    hgt, wid = spec["frame_size"]
    n = POOL_FRAMES
    k = max(o for _, o in spec["videos"] + [spec["warmup_video"]])
    gen = torch.Generator(device=device).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=device)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, **f32)

    extent = torch.tensor([hgt, wid], **f32)
    radii = uniform((k, 2), *ELLIPSE_RADIUS) * extent
    lo, hi = radii, extent - radii
    centre = uniform((k, 2), 0.25, 0.75) * extent
    speed = ELLIPSE_SPEED_PX
    velocity = uniform((k, 2), -speed, speed)
    colour = uniform((k, 3), 40.0, 255.0)
    yy = torch.arange(hgt, **f32)[:, None]
    xx = torch.arange(wid, **f32)[None, :]
    base = torch.stack(torch.broadcast_tensors(
        yy / hgt, xx / wid, (yy + xx) / (hgt + wid)), dim=-1) * 160
    images = torch.empty((n, hgt, wid, 3), dtype=torch.uint8,
                         pin_memory=torch.device(device).type == "cuda")
    labels = []
    for t0 in range(0, n, _CHUNK):
        t = torch.arange(t0, min(n, t0 + _CHUNK), **f32)
        pos = _bounce(centre + t[:, None, None] * velocity, lo, hi)  # T, K, 2
        dy = (yy - pos[..., 0, None, None]) / radii[:, 0, None, None]
        dx = (xx - pos[..., 1, None, None]) / radii[:, 1, None, None]
        inside = dy * dy + dx * dx <= 1                          # (T, K, H, W)
        img = base + 6 * torch.randn((len(t), hgt, wid, 3), generator=gen,
                                     **f32)
        lab = torch.zeros((len(t), hgt, wid), dtype=torch.uint8, device=device)
        for i in range(k):
            img = torch.where(inside[:, i, ..., None], colour[i], img)
            lab[inside[:, i]] = i + 1
        images[t0:t0 + len(t)].copy_(img.clamp_(0, 255).to(torch.uint8))
        labels.append(lab)
    return images, torch.cat(labels).cpu().numpy()

