"""Span tracer: nested, labeled wall-clock spans with device-sync
boundaries (``repro.obs.tracer``).

* ``Tracer.span(name, **attrs)`` opens a nested wall-clock span as a
  context manager. Calling ``sp.sync(out)`` inside the block makes the
  span wait, at close, until the card has finished the work that produced
  ``out`` before it stamps its end time, so asynchronously launched CUDA
  work is billed to the stage that launched it rather than to whichever
  later host sync absorbs it. On CPU tensors the wait does nothing.
* ``Tracer.add(...)`` records a synthetic closed span under a parent
  index (the reference attaches its per-round kernel spans this way).
* ``spans()`` lists the closed spans; ``rollup()`` folds them into a
  per-name {count, total, self, max} table; ``stage_rollup()`` keeps the
  outermost stage-classified spans only (``STAGE_PREFIXES``), the
  per-stage cost table whose sum is compared with wall time;
  ``chrome_trace()``/``write_chrome_trace()`` export the Chrome
  trace-event format of the reference key for key, so Chrome and Perfetto
  open both packages' traces alike.
* While a ``profile.profiler_trace`` capture runs, each span also opens a
  ``torch.profiler.record_function`` of its own name, so the device
  timeline carries the span names (the reference's ``jax.named_scope``
  labels). With no capture running it adds nothing.

A DISABLED tracer is the module-level ``NULL_TRACER`` singleton: every
``span()`` returns one shared no-op handle, ``add`` returns at once, and
no clock is read.

Single-threaded by design: spans must be closed in LIFO order on one
thread.
"""
from __future__ import annotations

import dataclasses
import json
import time

import torch

#: name prefixes classified as *stages* for the per-stage rollup: device
#: dispatch stages, kernel measurements, merge-schedule phases and host
#: pre/post-processing. Request-level ``engine/*`` spans are containers,
#: not stages: their children carry the cost.
STAGE_PREFIXES = ("stage/", "kernel/", "merge/", "host/")

#: the ``record_function`` label of each open span while a profiler
#: capture runs (``profile.profiler_trace`` switches it on)
_PROFILER_LABELS = {"on": False}


def cuda_devices(value) -> set:
    """The CUDA devices of the tensors in ``value``: a tensor, or any
    nesting of tuples, lists, dict values and dataclass fields around
    tensors (an ``EdgeList``, a certificate-state tuple, a list of them)."""
    found = set()
    stack = [value]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                found.add(v.device)
        elif isinstance(v, (tuple, list)):
            stack.extend(v)
        elif isinstance(v, dict):
            stack.extend(v.values())
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            stack.extend(getattr(v, f.name) for f in dataclasses.fields(v))
    return found


class Span:
    """One open (then closed) span. Use via ``with tracer.span(...) as sp``.

    ``sp.sync(value)`` registers a value to wait for at span close.
    ``sp.t0``/``sp.dur``/``sp.index`` are readable after the with-block.
    """

    __slots__ = ("tracer", "name", "attrs", "t0", "dur", "index", "depth",
                 "parent", "_pending", "_label")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0 = self.dur = 0.0
        self.index = -1
        self.depth = 0
        self.parent = -1
        self._pending = None
        self._label = None

    def sync(self, value):
        """Wait for ``value`` at span close (device-sync boundary)."""
        self._pending = value
        return value

    def __enter__(self):
        tr = self.tracer
        self.depth = len(tr._stack)
        self.parent = tr._stack[-1].index if tr._stack else -1
        self.index = tr._reserve()
        tr._stack.append(self)
        if _PROFILER_LABELS["on"]:
            self._label = torch.profiler.record_function(self.name)
            self._label.__enter__()
        self.t0 = tr._clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._pending is not None:
            for device in cuda_devices(self._pending):
                torch.cuda.synchronize(device)
            self._pending = None
        tr = self.tracer
        self.dur = tr._clock() - self.t0
        if self._label is not None:
            self._label.__exit__(exc_type, exc, tb)
            self._label = None
        assert tr._stack and tr._stack[-1] is self, (
            f"span {self.name!r} closed out of LIFO order")
        tr._stack.pop()
        tr._commit(self)
        return False


class Tracer:
    """Collects spans; export via ``chrome_trace`` / ``rollup``."""

    enabled = True

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self.reset()

    def reset(self) -> None:
        #: closed spans as dicts, slot-ordered by span START (index)
        self._spans: list[dict | None] = []
        self._stack: list[Span] = []

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    #: a tracer is a callable: ``with tracer("stage/x"):`` == ``.span``
    __call__ = span

    def _reserve(self) -> int:
        self._spans.append(None)
        return len(self._spans) - 1

    def _commit(self, sp: Span) -> None:
        self._spans[sp.index] = {
            "name": sp.name, "t0": sp.t0, "dur": sp.dur, "depth": sp.depth,
            "parent": sp.parent, "index": sp.index, "attrs": sp.attrs,
        }

    def add(self, name: str, t0: float, dur: float, *, parent: int = -1,
            **attrs) -> None:
        """Record a synthetic closed span (a per-round child of a measured
        kernel span). ``parent`` is a closed span's ``index``."""
        depth = 0
        if 0 <= parent < len(self._spans) and self._spans[parent]:
            depth = self._spans[parent]["depth"] + 1
        self._spans.append({
            "name": name, "t0": t0, "dur": dur, "depth": depth,
            "parent": parent, "index": len(self._spans), "attrs": attrs,
        })

    def spans(self) -> list[dict]:
        """Closed spans, start-ordered (open spans are excluded)."""
        return [s for s in self._spans if s is not None]

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON object (``traceEvents`` complete
        events; microsecond timestamps; span attrs under ``args``)."""
        events = [{
            "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
            "args": {"name": "repro.obs"},
        }]
        for s in self.spans():
            events.append({
                "name": s["name"], "ph": "X", "pid": 0, "tid": 0,
                "ts": s["t0"] * 1e6, "dur": s["dur"] * 1e6,
                "args": {k: _jsonable(v) for k, v in s["attrs"].items()},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def rollup(self) -> dict[str, dict]:
        """Per-name rollup: {count, total_s, self_s, max_s}. ``self_s`` is
        a span's duration minus its direct children's."""
        spans = self.spans()
        child_total: dict[int, float] = {}
        for s in spans:
            if s["parent"] >= 0:
                child_total[s["parent"]] = (child_total.get(s["parent"], 0.0)
                                            + s["dur"])
        table: dict[str, dict] = {}
        for s in spans:
            row = table.setdefault(
                s["name"],
                {"count": 0, "total_s": 0.0, "self_s": 0.0, "max_s": 0.0})
            row["count"] += 1
            row["total_s"] += s["dur"]
            row["self_s"] += s["dur"] - child_total.get(s["index"], 0.0)
            row["max_s"] = max(row["max_s"], s["dur"])
        return table

    def stage_rollup(self, prefixes=STAGE_PREFIXES) -> dict[str, dict]:
        """Rollup restricted to OUTERMOST stage-classified spans: a span
        counts iff its name starts with one of ``prefixes`` and no ancestor
        already counted (nested probes and rounds are not billed twice)."""
        spans = self.spans()
        by_index = {s["index"]: s for s in spans}

        def outermost(s) -> bool:
            if not s["name"].startswith(prefixes):
                return False
            p = s["parent"]
            while p >= 0:
                ps = by_index.get(p)
                if ps is None:
                    break
                if ps["name"].startswith(prefixes):
                    return False
                p = ps["parent"]
            return True

        table: dict[str, dict] = {}
        for s in spans:
            if not outermost(s):
                continue
            row = table.setdefault(
                s["name"], {"count": 0, "total_s": 0.0, "max_s": 0.0})
            row["count"] += 1
            row["total_s"] += s["dur"]
            row["max_s"] = max(row["max_s"], s["dur"])
        return table

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
            f.write("\n")


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


class _NullSpan:
    """Shared no-op span handle: enter/exit/sync all do nothing."""

    __slots__ = ()
    t0 = 0.0
    dur = 0.0
    index = -1

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def sync(self, value):
        return value


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every call is a no-op returning shared
    singletons."""

    enabled = False

    def span(self, name: str = "", **attrs) -> _NullSpan:
        return _NULL_SPAN

    __call__ = span

    def add(self, *args, **kwargs) -> None:
        return None

    def reset(self) -> None:
        return None

    def spans(self) -> list:
        return []

    def chrome_trace(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def rollup(self) -> dict:
        return {}

    def stage_rollup(self, prefixes=STAGE_PREFIXES) -> dict:
        return {}

    def write_chrome_trace(self, path: str) -> None:
        return None


NULL_TRACER = NullTracer()
