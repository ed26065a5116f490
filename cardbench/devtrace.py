"""A run's device timeline, from ``torch.profiler``.

``DeviceTrace`` records the card's activity (kernels, copies, fills) over
the measured window; host activity is not profiled, since recording every
host operator slows a request several times over. Once the window has
closed it reduces the raw events:

* ``busy_s``: the union of the card's event intervals inside the window,
  and ``window_s`` the window's length (an untraced run reduces the
  events to ``busy_s()`` alone);
* ``kernel_s``: device seconds of the events whose name holds a part;
* ``device_ops``: device seconds by event name, largest first;
* ``idle_gaps``: the seconds in which the card was idle, summed by what
  the host was doing at the middle of each gap: the innermost of the
  program's tracer spans open there, or ``harness`` where none was (the
  client between requests), largest first.

The profiler stamps events in nanoseconds of the Unix epoch; the window
and the program's spans (``time.perf_counter`` seconds) are put on that
clock by one pair of readings taken when the window opens.
"""
from __future__ import annotations

import contextlib
import time

import torch

from cardbench.percentiles import union_length


def _device_events(prof, named: bool = True):
    """``(start_ns, end_ns, name)`` of the card's events (the name None
    where not ``named``), without the annotations the profiler mirrors
    onto the card."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == cuda and not ev.is_user_annotation():
            start = ev.start_ns()
            out.append((start, start + ev.duration_ns(),
                        ev.name() if named else None))
    return out


def _innermost_open(spans: list, points: list) -> list:
    """For each sorted point, the name of the shortest span that contains
    it (None where none does). ``spans``: ``(start, end, name)`` sorted by
    start."""
    out, open_spans, i = [], [], 0
    for p in points:
        while i < len(spans) and spans[i][0] <= p:
            open_spans.append(spans[i])
            i += 1
        open_spans = [s for s in open_spans if s[1] > p]
        out.append(min(open_spans, key=lambda s: s[1] - s[0])[2]
                   if open_spans else None)
    return out


class DeviceTrace:
    """Profile the card over a window; ``summary(spans)`` after it."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.window_ns = None
        self.offset_ns = None  # Unix ns minus perf_counter ns
        self.stop_s = None  # the profiler's stop, after the window
        self._summary = None
        self._busy_s = None

    @contextlib.contextmanager
    def window(self):
        self._prof.start()
        try:
            torch.cuda.synchronize()
            self.offset_ns = time.time_ns() - time.perf_counter_ns()
            start = time.time_ns()
            yield self
            torch.cuda.synchronize()
            self.window_ns = (start, time.time_ns())
        finally:
            t = time.perf_counter()
            self._prof.stop()
            self.stop_s = time.perf_counter() - t

    def busy_s(self) -> float:
        """The union of the card's event intervals inside the window."""
        if self._busy_s is None:
            if self._summary is not None:
                self._busy_s = self._summary["busy_s"]
            else:
                self._busy_s = union_length(
                    [(a, b) for a, b, _ in self._clipped(named=False)]) / 1e9
        return self._busy_s

    def _clipped(self, named: bool = True) -> list:
        w0, w1 = self.window_ns
        return [(max(a, w0), min(b, w1), name)
                for a, b, name in _device_events(self._prof, named)
                if b > w0 and a < w1]

    def summary(self, spans=()) -> dict:
        """The reduction above; ``spans`` are the program's tracer spans
        of the window, read once."""
        if self._summary is None:
            self._summary = self._reduce(spans)
        return self._summary

    def _reduce(self, spans) -> dict:
        w0, w1 = self.window_ns
        device = self._clipped()
        by_name: dict[str, float] = {}
        for a, b, name in device:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
        busy = sorted((a, b) for a, b, _ in device)
        gaps, last = [], w0
        for a, b in busy:
            if a > last:
                gaps.append((last, a))
            last = max(last, b)
        if last < w1:
            gaps.append((last, w1))
        host = sorted((s["t0"] * 1e9 + self.offset_ns,
                       (s["t0"] + s["dur"]) * 1e9 + self.offset_ns,
                       s["name"]) for s in spans)
        names = _innermost_open(host, [(a + b) / 2 for a, b in gaps])
        idle: dict[str, float] = {}
        for (a, b), name in zip(gaps, names):
            key = name or "harness"
            idle[key] = idle.get(key, 0.0) + (b - a) / 1e9
        return {
            "busy_s": union_length(busy) / 1e9,
            "window_s": (w1 - w0) / 1e9,
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1]),
            "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1]),
            "device_events": len(device),
        }

    def kernel_s(self, part: str) -> float:
        """Device seconds of the events whose name holds ``part``."""
        return sum(s for name, s in self.summary()["device_ops"]
                   if part in name)
