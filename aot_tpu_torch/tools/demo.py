"""Demo CLI of the port (the counterpart of tools/demo.py): propagates the
first frame's objects through every sequence of a datasets/Demo folder
(images/<seq>/*.jpg, masks/<seq>/<first>.png), writes one palettised PNG
mask a frame and, unless --no_video, an MJPG overlay video a sequence.

    python -m aot_tpu_torch.tools.demo --model r50_deaotl \\
        --ckpt_path <file.pth> --data_path ./datasets/Demo \\
        --output_path ./demo_output [--amp] [--frame_chunk 8]

Runs on cuda:0 unless --device names another (`--device cpu`), and raises
when there is no card. Frame by frame, as tools/demo.py:90-160 does: each
frame is resized so its long edge is at most max_resolution * 800 / 480
(stride-16 snapped); frame 0's label, nearest-resized to that input size,
is the reference; every later frame is stepped at the input size and its
mask upscaled (nearest) to the frame's own size. With --frame_chunk K the
largest power of two <= min(K, frames left) goes through step_chunk at
identity resample, with one upscale for the chunk: the masks equal the
per-frame ones. --amp serves in bf16 (TEST_DTYPE=bfloat16).

Weights: `--ckpt_path test` builds the port's seeded random model (the
JAX demo's flax init cannot be reproduced, so parity with it goes through
a .pth); a .pth (reference-keyed, or either stream of the port's trainer)
loads through utils/weights.load_model, strictly, where tools/demo.py's
load_torch_pretrained keeps missing parameters at their init.

Like tools/demo.py, the demo never grows the long-term memory ring: under
the default TEST_LONG_TERM_MEM_POLICY 'grow' with TEST_LONG_TERM_MEM_CAP 4,
every long-term write after the ring fills lands on its last slot (the
evaluator grows the ring instead).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="VOS demo (PyTorch)")
    parser.add_argument("--model", type=str, default="aott")
    parser.add_argument("--ckpt_path", type=str, default="test",
                        help="'test' = seeded random weights smoke mode")
    parser.add_argument("--data_path", type=str, default="./datasets/Demo")
    parser.add_argument("--output_path", type=str, default="./demo_output")
    parser.add_argument("--max_resolution", type=float, default=480)
    parser.add_argument("--amp", action="store_true",
                        help="bf16 inference (TEST_DTYPE=bfloat16)")
    parser.add_argument("--frame_chunk", type=int, default=1,
                        help=">1 = step K frames at a time (masks fed back "
                             "on the device; identical to per-frame "
                             "stepping)")
    parser.add_argument("--no_video", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda:0; raises without "
                             "a card unless --device cpu)")
    return parser


def main(argv=None) -> List[Dict[str, object]]:
    """Run the demo; returns per sequence its name, the frames stepped
    after the reference frame and the seconds they took (the FPS line's
    numbers)."""
    args = build_parser().parse_args(argv)

    from aot_tpu_torch.configs import build_config
    from aot_tpu_torch.data.eval_datasets import DemoTest
    from aot_tpu_torch.data.video_aug import multi_restrict_size
    from aot_tpu_torch.engine import build_infer_engine
    from aot_tpu_torch.utils.weights import load_model
    from aot_tpu_torch.ops.image import interpolate_nearest, nearest_labels
    from aot_tpu_torch.utils.device import resolve_device
    from aot_tpu_torch.utils.image import (label2colormap, masked_image,
                                           save_mask_async)

    cfg = build_config(stage="pre_ytb_dav", model=args.model,
                       TEST_DTYPE="bfloat16" if args.amp else "float32")
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eng = build_infer_engine(load_model(cfg, args.ckpt_path, device), cfg)
    dataset = DemoTest(args.data_path)

    def upscale(pred: torch.Tensor, size) -> np.ndarray:
        """(N, h, w) labels -> (N, H, W) uint8 on the host (nearest)."""
        big = interpolate_nearest(pred[..., None].float(), tuple(size))
        return big[..., 0].to(torch.uint8).cpu().numpy()

    stats = []
    for si in range(len(dataset)):
        seq = dataset[si]
        print(f"sequence {seq.seq_name}: {len(seq)} frames")
        out_mask_dir = os.path.join(args.output_path, seq.seq_name)
        os.makedirs(out_mask_dir, exist_ok=True)
        video_frames = []
        writes = []
        t0 = time.perf_counter()
        n_stepped = 0
        state = None

        def prep(sample):
            v = multi_restrict_size(
                sample["image"], sample["label"], multi_scale=[1.0],
                max_long_edge=args.max_resolution * 800 / 480,
                align_corners=cfg.MODEL_ALIGN_CORNERS)[0]
            return v["image"], v["image"].shape[:2]

        def emit(pred_np, sample):
            name = (os.path.splitext(sample["meta"]["current_name"])[0]
                    + ".png")
            writes.append(save_mask_async(pred_np,
                                          os.path.join(out_mask_dir, name)))
            if not args.no_video:
                image = sample["image"]
                overlay = masked_image(
                    image / 255.0, label2colormap(pred_np) / 255.0, pred_np)
                video_frames.append((overlay * 255).astype(np.uint8))

        fi = 0
        while fi < len(seq):
            sample = seq[fi]
            image, label = sample["image"], sample["label"]
            small, in_size = prep(sample)
            if fi == 0:
                lab = torch.from_numpy(np.asarray(label, np.int64))[None]
                state = eng.add_reference_frame(
                    torch.from_numpy(small[None]).to(device),
                    nearest_labels(lab, in_size).to(device),
                    int(label.max()))
                emit(np.asarray(label, np.uint8), sample)
                fi += 1
                continue
            remaining = len(seq) - fi
            k = 1 << (min(max(args.frame_chunk, 1), remaining)
                      .bit_length() - 1)
            if k >= 2:
                samples = [sample] + [seq[fi + j] for j in range(1, k)]
                smalls = [small] + [prep(s)[0] for s in samples[1:]]
                imgs = torch.from_numpy(np.stack([s[None] for s in smalls]))
                state, preds = eng.step_chunk(state, imgs.to(device),
                                              tuple(in_size), tuple(in_size))
                big_np = upscale(preds[:, 0], image.shape[:2])
                for j, s in enumerate(samples):
                    emit(big_np[j], s)
                n_stepped += k
                fi += k
                continue
            state, pred, _ = eng.step(
                state, torch.from_numpy(small[None]).to(device),
                tuple(in_size))
            n_stepped += 1
            emit(upscale(pred, image.shape[:2])[0], sample)
            fi += 1
        dt = time.perf_counter() - t0
        for t in writes:
            t.join()
        print(f"  {n_stepped / max(dt, 1e-9):.1f} FPS")
        stats.append({"seq": seq.seq_name, "frames": n_stepped,
                      "seconds": dt})
        if not args.no_video and video_frames:
            import cv2

            h, w = video_frames[0].shape[:2]
            vw = cv2.VideoWriter(
                os.path.join(args.output_path, seq.seq_name + ".avi"),
                cv2.VideoWriter_fourcc(*"MJPG"), 15, (w, h))
            for f in video_frames:
                vw.write(f[:, :, ::-1])
            vw.release()
    print(f"results saved to {args.output_path}")
    return stats


if __name__ == "__main__":
    main()
