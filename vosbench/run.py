"""Run one cell of the benchmark once, on the card it is started on.

    python3 vosbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The last line of standard output is one
JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
`device`, with --trace 1 `breakdown`, and last `checks`, the numbers the
comparison with the reference made, each beside its limit. The same
numbers are the last lines of standard error. vosbench/README.md says how
each metric is taken.

Exits non-zero, printing no result, without a CUDA card, when the program
is missing, or when JAX or the JAX package was loaded.
"""

import time

T_PROCESS = time.perf_counter()   # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# every build and kernel cache of the run stays in the checkout, at fixed
# paths (the port's nvcc builds already go to build/aot_tpu_torch/)
os.environ["CUDA_CACHE_PATH"] = str(CHECKOUT / "build" / "cuda_cache")
os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton_cache")
sys.path.insert(0, str(CHECKOUT))

THREADS = 1        # torch's host threads: one, for steady host times


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from vosbench.harness import forbidden_modules, load_cell, run_cell

    bench = CHECKOUT / "BENCHMARK.json"
    entry = {w["name"]: w for w in json.loads(bench.read_text())
             ["workloads"]}.get(args.workload)
    if entry is None:
        print(f"vosbench: no workload {args.workload!r} in {bench}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < entry["chips"]):
        print(f"vosbench: {args.workload} needs {entry['chips']} CUDA "
              f"card(s); torch sees {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(THREADS)
    cell = load_cell(bench, args.workload)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", T_PROCESS)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"vosbench: the run loaded {found}: neither JAX nor the JAX "
              "package may run here", file=sys.stderr)
        return 3
    timing = result.pop("timing")
    print(f"vosbench timing: check {timing['check_s']:.1f} s, frames a "
          f"second {timing['per_second']}", file=sys.stderr)
    print("vosbench logit_err by (video, frame): " + " ".join(
        f"{v}:{t}:{e:.2e}" for v, t, e in timing["drift"]), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"vosbench check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(finite(result)), flush=True)
    return 0


def finite(x):
    """x with every NaN or infinity replaced by null (plain JSON)."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


if __name__ == "__main__":
    sys.exit(main())
