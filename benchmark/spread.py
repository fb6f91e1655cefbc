"""The spread of a cell's end-to-end metrics over sets of runs, as its
bounds are set: for each set, (third quartile - first quartile) / median
with ``statistics.quantiles(values, n=4)``, and for each metric the wider
of the sets' spreads.

    python3 benchmark/spread.py RESULTS [RESULTS ...]

Each RESULTS file holds the result lines (the last stdout line of
``run.py``) of one set of runs, one a line.
"""

from __future__ import annotations

import json
import statistics
import sys


def quartile_spread(values: list[float]) -> float:
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def main(paths: list[str]) -> int:
    sets = []
    for path in paths:
        with open(path) as f:
            sets.append([json.loads(line) for line in f if line.strip()])
    names = sorted({m for s in sets for r in s for m in r["metrics"]})
    for name in names:
        per_set = []
        for s in sets:
            values = [r["metrics"][name]["value"] for r in s if name in r["metrics"]]
            per_set.append((statistics.median(values), quartile_spread(values), values))
        widest = max(sp for _, sp, _ in per_set)
        print(json.dumps({"metric": name, "medians": [m for m, _, _ in per_set],
                          "spreads": [sp for _, sp, _ in per_set], "widest": widest,
                          "five_times": 5 * widest, "values": [v for *_, v in per_set]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
