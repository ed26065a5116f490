"""Metrics registry: counters, gauges, and fixed-bucket latency histograms
(``repro.obs.metrics``, copied: host-only Python).

Pure Python (no numpy, no torch), so the registry can sit on every hot
path — ``observe``/``inc``/``set`` are O(1) with no allocation beyond the
first call. One ``snapshot()`` call folds everything into a plain
JSON-able dict.

* ``Counter`` — monotone int, ``inc(n)``.
* ``Gauge`` — last-write-wins float plus the wall-clock timestamp of the
  last write (``updated_at``). The engine publishes ``mem/live_bytes``
  and ``mem/peak_live_bytes`` here.
* ``Histogram`` — fixed upper-bound buckets with an overflow slot.
  ``percentile(q)`` linearly interpolates inside the hit bucket (numpy
  ``quantile``-style rank ``q·(count−1)``), clamped to the observed
  min/max, so the answer is exact at the extremes and within one bucket
  width elsewhere.
"""
from __future__ import annotations

import bisect
import math
import time


def default_latency_buckets() -> tuple[float, ...]:
    """Exponential seconds buckets, 10µs → ~85s at ×1.5 — wide enough for
    a cold first run and fine enough (±~20%) for steady-state serving."""
    bounds, b = [], 1e-5
    while b < 100.0:
        bounds.append(b)
        b *= 1.5
    return tuple(bounds)


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    __slots__ = ("name", "value", "updated_at")

    def __init__(self, name: str):
        self.name = name
        self.value = None
        self.updated_at = None

    def set(self, v: float) -> None:
        self.value = v
        self.updated_at = time.time()

    def snapshot(self):
        return {"value": self.value, "updated_at": self.updated_at}


class Histogram:
    """Fixed-bucket histogram; ``bounds`` are ascending bucket upper
    bounds, with an implicit overflow bucket above the last."""

    __slots__ = ("name", "bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, name: str, bounds=None):
        self.name = name
        self.bounds = tuple(float(b) for b in
                            (bounds if bounds is not None
                             else default_latency_buckets()))
        if list(self.bounds) != sorted(self.bounds) or not self.bounds:
            raise ValueError(f"histogram {name!r}: bounds must be ascending "
                             f"and non-empty")
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        self.min = v if v < self.min else self.min
        self.max = v if v > self.max else self.max

    def percentile(self, q: float) -> float | None:
        """The q-quantile (q in [0, 1]) under the within-bucket-uniform
        assumption; None when empty."""
        if self.count == 0:
            return None
        rank = q * (self.count - 1)
        if rank <= 0:  # exact at the extremes
            return self.min
        if rank >= self.count - 1:
            return self.max
        cum = 0
        for i, c in enumerate(self.counts):
            if c and rank < cum + c:
                lo = self.bounds[i - 1] if i > 0 else min(self.min, self.bounds[0])
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                if hi <= lo:
                    return max(min(hi, self.max), self.min)
                frac = (rank - cum + 0.5) / c
                return lo + min(max(frac, 0.0), 1.0) * (hi - lo)
            cum += c
        return self.max

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "mean": self.sum / self.count if self.count else None,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }


class MetricsRegistry:
    """Get-or-create named metrics; ``snapshot()`` rolls everything up."""

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, *args)
        elif not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, bounds=None) -> Histogram:
        h = self._metrics.get(name)
        if h is None:
            h = self._metrics[name] = Histogram(name, bounds)
        elif not isinstance(h, Histogram):
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{type(h).__name__}, not Histogram")
        return h

    def names(self) -> tuple[str, ...]:
        return tuple(self._metrics)

    def snapshot(self) -> dict:
        """One dict: metric name -> value (counters), {value, updated_at}
        (gauges), or the percentile rollup (histograms)."""
        return {name: m.snapshot() for name, m in self._metrics.items()}

    def reset(self) -> None:
        self._metrics.clear()
