"""Readings of the numbers a cell's comparison reads, for many seeds in one
process: the program as configured ("program") and its control ("control":
the same entry with the program's bf16 taps), each seed a short window at
the cell's own load, from set-up to comparison as a run does it.

    python3 portbench/tools/readings.py --workload <cell> --seeds 1,2,3 \
        --variant program --seconds 3

One JSON line a seed: {"seed", "variant", "frames", "checks"}. The limits
in the configuration files were set from these lines (PERF.md §2).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/tools/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--variant", choices=("program", "control"), default="program")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.find_cell(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        result = harness.run_cell(ROOT, cell, seed, args.seconds, False, "cuda",
                                  time.perf_counter(), log=lambda m: None,
                                  variant=args.variant)
        print(json.dumps({"seed": seed, "variant": args.variant,
                          "frames": result["attempted"], "checks": result["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
