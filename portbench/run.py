"""Run one cell of BENCHMARK.json once on the card, and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run loads (or builds) the port's kernels,
makes the cell's inputs from the seed, warms up the cell's shapes, measures
for --seconds, compares what the window produced with the plain reference,
and prints one JSON object as the last line of standard output: with
--trace 0 the cell's end-to-end metrics, with --trace 1 its per-layer
metrics from a torch.profiler trace of the window. The numbers compared are
the last lines of standard error. Without a CUDA card, or with fewer cards
than the cell asks for, it exits 2 and prints no result; where the port
imported JAX or the JAX package, it exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from portbench import harness

    cell = harness.find_cell(ROOT, args.workload)
    import image_denoising_filter_tpu_torch as port
    import torch

    if not Path(port.__file__).resolve().is_relative_to(ROOT):
        print(f"portbench: the port was imported from {port.__file__}, not from {ROOT}",
              file=sys.stderr)
        return 1

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), found {have}",
              file=sys.stderr)
        return 2

    def log(msg: str) -> None:
        print(f"portbench: {msg}", flush=True)

    try:
        result = harness.run_cell(ROOT, cell, args.seed, args.seconds, bool(args.trace),
                                  "cuda", T_START, log)
    except harness.ForbiddenImport as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
