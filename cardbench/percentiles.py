"""Statistics the benchmark reports, kept here so that they do not move
when the program changes.

* ``percentile``: exact, nearest rank, over every recorded value (the
  program's ``obs/metrics.py`` histograms keep fixed buckets, which
  blur a tail).
* ``spread``: the distance between the first and the third quartile as
  ``statistics.quantiles(values, n=4)`` gives them, as a share of the
  median: the spread a bound is set from.
* ``union_length``: the length covered by a set of intervals, counting an
  overlap once: the device's busy time from its events.
"""
from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least ``q`` percent of the values at or below it."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("percentile of no values")
    rank = max(math.ceil(q / 100 * len(ordered)), 1)
    return ordered[rank - 1]


def spread(values) -> float:
    """(Q3 - Q1) / median of ``values``."""
    q1, median, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / median


def union_length(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total = 0.0
    cur_start = cur_end = None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        elif end > cur_end:
            cur_end = end
    if cur_end is not None:
        total += cur_end - cur_start
    return total
