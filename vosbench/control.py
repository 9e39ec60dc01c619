"""The control: the reference put in the program's place, computed in the
precision just below the configuration's (fp32 with TF32 off -> TF32), and
judged by the same check as the program. Its numbers set the upper reading
of each limit in the workload files; it has to come out not correct.

    python3 vosbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

runs on the card at the cell's own size, one run a seed in one process,
and prints one JSON line a seed with the check's numbers. The benchmark's
own runs never run it. On a device without TF32 (the CPU tests) the
control rounds the weights to TF32 instead (`emulate=True`).
"""

from __future__ import annotations

import contextlib
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(CHECKOUT))

from vosbench import reference  # noqa: E402


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32's 10-bit mantissa, to nearest (ties away)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


class ReferenceServer:
    """The reference serving a stream, as the program would: its own
    argmax masks written back into its memory."""

    def __init__(self, cell, weights, device, emulate: bool = False):
        params = ({k: round_tf32(v) if v.ndim >= 2 else v
                   for k, v in weights.items()} if emulate else weights)
        self.ref = reference.load(cell.root)
        self.model = self.ref.model.Model(params, cell.config)
        self.cell = cell
        self.precision = contextlib.nullcontext if emulate else tf32

    def start(self, img, mask, objects: int) -> None:
        engine = self.cell.workload.get("engine", {})
        self.stream = self.ref.stream.Stream(
            self.model, self.cell.config["TEST_LONG_TERM_MEM_GAP"],
            engine.get("TEST_LONG_TERM_MEM_POLICY", "grow"),
            engine.get("TEST_LONG_TERM_MEM_CAP", 0))
        with torch.inference_mode(), self.precision():
            self.stream.reference_frame(img, mask, objects)

    def step(self, img, size):
        with torch.inference_mode(), self.precision():
            logits = self.stream.propagate(img)
            pred = self.model.upsample(logits, size).argmax(dim=1)
            self.stream.write(pred)
        return pred, logits, 0.0

    def close(self) -> None:
        self.stream = self.model = None


def reference_program(emulate: bool = False):
    def build(cell, weights, device):
        return ReferenceServer(cell, weights, device, emulate)
    return build


def main(argv=None) -> int:
    from vosbench.harness import load_cell, run_cell

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("vosbench control: no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(CHECKOUT / "BENCHMARK.json", args.workload)
    for seed in args.seeds:
        res = run_cell(cell, seed, args.seconds, False, "cuda:0", T_PROCESS,
                       program=reference_program())
        print(json.dumps({"control": args.workload, "seed": seed,
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
