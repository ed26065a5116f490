"""The spread of each end-to-end metric over the sets ``sets.py`` wrote,
and the bound it suggests.

    python3 cardbench/spread.py runs/*.jsonl

For each cell and metric: each set's median and spread (the distance
between the quartiles as a share of the median, ``percentiles.spread``),
the mean of the sets' spreads with each set's run farthest from its
median left out (what a check holds a bound's tightness to), the spread
of all runs together (what it holds looseness to), the second set's
median over the first's, and five times the widest spread, never under
1%. Runs that are not correct are counted and left out.
"""
from __future__ import annotations

import json
import statistics
import sys
from collections import defaultdict

if __name__ == "__main__":
    from pathlib import Path

    sys.path[0:1] = [str(Path(__file__).resolve().parents[1])]

from cardbench.percentiles import spread  # noqa: E402


def _trimmed(values: list) -> list:
    """``values`` without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def summarize(records: list) -> dict:
    by_cell: dict = defaultdict(lambda: defaultdict(lambda: defaultdict(
        list)))
    wrong: dict = defaultdict(int)
    for rec in records:
        res = rec.get("result")
        if rec["trace"] or rec["set"] < 0:
            continue
        if not res or not res.get("correct"):
            wrong[rec["workload"]] += 1
            continue
        for name, m in res["metrics"].items():
            by_cell[rec["workload"]][name][rec["set"]].append(m["value"])
    out = {}
    for cell, metrics in by_cell.items():
        rows = {}
        for name, sets in metrics.items():
            groups = [sets[k] for k in sorted(sets)]
            every = [v for g in groups for v in g]
            if len(every) < 4:
                continue
            spreads = [spread(g) for g in groups if len(g) >= 4]
            tight = [spread(_trimmed(g)) for g in groups if len(g) >= 5]
            rows[name] = {
                "medians": [statistics.median(g) for g in groups],
                "spreads": spreads,
                "trimmed_mean": statistics.mean(tight) if tight else None,
                "all_runs": spread(every),
                "second_over_first": (statistics.median(groups[1])
                                      / statistics.median(groups[0])
                                      if len(groups) > 1 else None),
                "five_times_widest": max(0.01, 5 * max(spreads + [
                    spread(every)])),
            }
        out[cell] = {"not_correct": wrong[cell], "metrics": rows}
    return out


def main(argv=None) -> int:
    records = []
    for path in (argv if argv is not None else sys.argv[1:]):
        with open(path) as f:
            records += [json.loads(line) for line in f if line.strip()]
    print(json.dumps(summarize(records), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
