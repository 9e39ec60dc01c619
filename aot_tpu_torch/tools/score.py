"""J&F of a results folder against its ground truth (the counterpart of
tools/score.py): per-sequence PNG folders against an Annotations folder,
with the port's scorer (aot_tpu_torch.eval.metrics.evaluate_davis).

    python -m aot_tpu_torch.tools.score <results> <annotations> \\
        [--seqs S ...] [--json]

The scoring runs on the host (numpy): it has no --device.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Score VOS results (J&F)")
    p.add_argument("results", help="per-sequence prediction PNG dirs")
    p.add_argument("annotations", help="ground-truth Annotations dir")
    p.add_argument("--seqs", nargs="+", default=None)
    p.add_argument("--json", action="store_true", help="print one JSON line")
    args = p.parse_args(argv)

    from aot_tpu_torch.eval.metrics import evaluate_davis

    out = evaluate_davis(args.results, args.annotations, args.seqs,
                         verbose=not args.json)
    if args.json:
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
