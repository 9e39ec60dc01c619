"""The comparison that decides `correct`.

Once the window has closed and the program's state is freed, the plain
reference (the cell's own: `reference/` under its root) replays a sample of
the videos that the program served. The sample is drawn from the seed
before the window, from the stream's first pass (one play of every video of
the cell's list, which the window serves before any repeat; where a cell's
window serves less than a pass, from the videos that start within the
pass's first `within_frames` frames), the longest always in it, so that
only those videos keep their masks while the window runs; a cell whose
stream is one video replays that video from its first frame, set-up
included, and a video the window did not reach has nothing to replay. The
reference makes its memory again from the same frames and weights, and
writes into it the masks the program served (it reads them only to judge
them). At every frame it compares:

  mask_gap   the widest gap by which the reference's logit of the served
             label, upsampled to the frame, lies below its best logit
             there;
  logit_err  where the program's grid logits were kept (every
             `keep_logits_every`-th frame and each video's last frame), the
             largest absolute difference from the reference's.

Both are taken relative to the largest live logit the reference gives on
that frame. Each has a limit in the cell's workload file (`limits`);
`correct` holds when every number is within its limit and frames were
compared.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional

import numpy as np
import torch

from vosbench import reference


def sample_videos(first_pass, seed: int, count: int,
                  within_frames: Optional[int] = None) -> List[int]:
    """Stream indices of the checked videos: the longest video of the
    first pass (the first of equals) and count - 1 others of the pass drawn
    from the seed. With `within_frames`, only the pass's videos whose first
    frame lies within the stream's first `within_frames` frames take part:
    where the window serves less than a pass, the checked videos are then
    all served."""
    if within_frames is not None:
        starts = itertools.accumulate([0] + [v.frames for v in first_pass])
        first_pass = [v for v, s in zip(first_pass, starts)
                      if s < within_frames]
    if not first_pass:
        return []
    longest = max(first_pass, key=lambda v: (v.frames, -v.index)).index
    rest = sorted(v.index for v in first_pass if v.index != longest)
    rng = np.random.default_rng([seed, 1])
    pick = rng.choice(len(rest), size=min(count - 1, len(rest)),
                      replace=False) if rest else []
    return [longest] + sorted(rest[i] for i in pick)


def frame_numbers(ref_logits, served_mask, kept_logits, model,
                  obj_num: int, size):
    """(mask_gap, logit_err or None) of one frame."""
    live = ref_logits[..., :obj_num + 1]
    scale = live.abs().max().clamp_min(1e-30)
    up = model.upsample(ref_logits, size)                 # (1, C, H, W)
    label = served_mask.long()[:, None]
    gap = (up.max(dim=1, keepdim=True).values - up.gather(1, label)).max()
    gap = float(gap / scale)
    err = None
    if kept_logits is not None:
        err = float((kept_logits.to(ref_logits.device) - ref_logits).abs()
                    .max() / scale)
    return gap, err


@torch.inference_mode()
def check(cell, runner, weights, traffic, device) -> Dict:
    wl = cell.workload
    limits = wl["limits"]
    ref = reference.load(cell.root)
    model = ref.model.Model(weights, cell.config)
    engine = wl.get("engine", {})
    policy = engine.get("TEST_LONG_TERM_MEM_POLICY", "grow")
    videos = [v for v in runner.checked if v in runner.videos]
    by_video: Dict[int, list] = {}
    for f in runner.frames:
        if f.video in videos:
            by_video.setdefault(f.video, []).append(f)
    gaps, errs, drift, compared = [], [], [], 0
    for v in videos:
        frames = sorted(by_video[v], key=lambda f: f.t)
        video = runner.videos[v]
        stream = ref.stream.Stream(
            model, cell.config["TEST_LONG_TERM_MEM_GAP"], policy,
            engine.get("TEST_LONG_TERM_MEM_CAP", 0))
        for f in frames:
            img = traffic.image(video, f.t)[None].to(device)
            if f.kind == "ref":
                mask = torch.from_numpy(traffic.mask(video)[None]).to(device)
                stream.reference_frame(img, mask.long(), video.objects)
                continue
            served = torch.from_numpy(f.mask[None]).to(device)
            logits = stream.propagate(img)
            gap, err = frame_numbers(logits, served, f.logits, model,
                                     video.objects, traffic.size)
            gaps.append(gap)
            if err is not None:
                errs.append(err)
                drift.append((v, f.t, err))
            stream.write(served.long())
            compared += 1
        del stream
    numbers = {
        "mask_gap": {"value": max(gaps) if gaps else float("nan"),
                     "limit": limits["mask_gap"]},
        "logit_err": {"value": max(errs) if errs else float("nan"),
                      "limit": limits["logit_err"]},
        "frames_compared": {"value": compared, "limit": 1},
        "logit_frames_compared": {"value": len(errs), "limit": 1},
    }
    correct = (numbers["mask_gap"]["value"] <= limits["mask_gap"]
               and numbers["logit_err"]["value"] <= limits["logit_err"]
               and compared >= 1 and len(errs) >= 1)
    return {"correct": correct, "numbers": numbers, "drift": drift}
