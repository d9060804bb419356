"""The spread of a cell's end-to-end metrics over sets of runs, from which
BENCHMARK.json's bounds were set (PERF.md §2).

    python3 portbench/tools/spread.py <set A's outputs> -- <set B's outputs>

Each output is a run's standard output; its last line is the result. For
each metric and set: the median, the first and third quartiles
(statistics.quantiles(values, n=4)), and the spread, their distance as a
share of the median; then the wider spread of the sets, and the bound of
five times it (never under 1%).
"""

import json
import statistics
import sys


def result(path: str) -> dict:
    with open(path) as f:
        return json.loads(f.read().strip().splitlines()[-1])


def spread(values) -> tuple[float, float, float, float]:
    q1, med, q3 = statistics.quantiles(values, n=4)
    return statistics.median(values), q1, q3, (q3 - q1) / statistics.median(values)


def main(argv) -> int:
    sets, cur = [], []
    for a in argv:
        if a == "--":
            sets.append(cur)
            cur = []
        else:
            cur.append(a)
    sets.append(cur)
    runs = [[result(p) for p in s] for s in sets if s]
    names = sorted({m for s in runs for r in s for m in r["metrics"]})
    for name in names:
        widest = 0.0
        for i, s in enumerate(runs):
            values = [r["metrics"][name]["value"] for r in s if name in r["metrics"]]
            med, q1, q3, sp = spread(values)
            widest = max(widest, sp)
            print(f"{name} set {i}: n {len(values)} median {med!r} q1 {q1!r} q3 {q3!r} "
                  f"spread {sp:.5f} correct {sum(r['correct'] for r in s)}/{len(s)}")
        print(f"{name}: widest spread {widest:.5f}, bound 5x {max(0.01, 5 * widest):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
