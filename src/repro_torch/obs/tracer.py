"""Span tracer: nested, labeled wall-clock spans with device-sync
boundaries (``repro.obs.tracer``).

* ``Tracer.span(name, **attrs)`` opens a nested wall-clock span as a
  context manager. Calling ``sp.sync(out)`` inside the block makes the
  span wait, at close, until the card has finished the work that produced
  ``out`` before it stamps its end time, so asynchronously launched CUDA
  work is billed to the stage that launched it rather than to whichever
  later host sync absorbs it. On CPU tensors the wait does nothing.
* ``Tracer.span(name, stream=device)`` opens a STREAM span: it also
  records a CUDA event on the device's current stream at enter and at
  exit, with no host sync, so the interval in which the card's stream did
  the span's work is known even where the host left the span long before.
  ``spans()`` resolves the events once, after one synchronize, and puts
  the stream interval on the tracer's own clock as ``attrs["device_t0"]``
  (seconds) and ``attrs["device_ms"]``; ``t0``/``dur`` stay the host's.
  The mapping is an ANCHOR per device: one event recorded on an idle
  stream and the host stamp as its record returns, taken at the first
  stream span (after one stream sync) and again at every synced span's
  close, which has just synchronized anyway, so the two clocks cannot
  drift apart over a long window. On the CPU (``stream=`` a CPU device,
  or ``True`` before CUDA is initialized) the host is the stream:
  ``device_*`` is the host's own interval. ``stream=True`` names the
  current CUDA device.
* A span attribute may be a 0-dim tensor (a LAZY attribute, such as a
  count the card holds): ``spans()`` resolves every such attribute in one
  batched readback per device and dtype, so tracing adds no readback
  where the value is made.
* ``Tracer.add(...)`` records a synthetic closed span under a parent
  index (the reference attaches its per-round kernel spans this way).
* ``Tracer.count(key, n)`` adds ``n`` to a counter that the innermost
  open span opened (``span(name, key=0)``), so code under the span counts
  into it without a handle on the span.
* ``spans()`` lists the closed spans; ``rollup()`` folds them into a
  per-name {count, total, self, max} table; ``stage_rollup()`` keeps the
  outermost stage-classified spans only (``STAGE_PREFIXES``), the
  per-stage cost table whose sum is compared with wall time;
  ``chrome_trace()``/``write_chrome_trace()`` export the Chrome
  trace-event format of the reference key for key, so Chrome and Perfetto
  open both packages' traces alike; stream spans add their device
  intervals on a second track (``tid`` 1, "card stream").
* While a ``profile.profiler_trace`` capture runs, each span also opens a
  ``torch.profiler.record_function`` of its own name, so the device
  timeline carries the span names (the reference's ``jax.named_scope``
  labels). With no capture running it adds nothing.

A DISABLED tracer is the module-level ``NULL_TRACER`` singleton: every
``span()`` (``stream=`` too) returns one shared no-op handle, ``add``
returns at once, and no clock is read and no event recorded.

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
    ``stream`` is ``None`` for a host span, ``"host"`` for a stream span
    whose stream is the host, or the CUDA device whose current stream it
    records events on.
    """

    __slots__ = ("tracer", "name", "attrs", "t0", "dur", "index", "depth",
                 "parent", "_pending", "_label", "stream", "_events")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict,
                 stream=None):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0 = self.dur = 0.0
        self.index = -1
        self.depth = 0
        self.parent = -1
        self._pending = None
        self._label = None
        self.stream = stream
        self._events = None

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
        if isinstance(self.stream, torch.device):
            self._events = (tr._anchor(self.stream), _record(self.stream))
        self.t0 = tr._clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._events is not None:
            self._events += (_record(self.stream),)
        synced = ()
        if self._pending is not None:
            synced = cuda_devices(self._pending)
            for device in synced:
                torch.cuda.synchronize(device)
            self._pending = None
        tr = self.tracer
        self.dur = tr._clock() - self.t0
        for device in synced:
            tr._take_anchor(device)
        if self._label is not None:
            self._label.__exit__(exc_type, exc, tb)
            self._label = None
        assert tr._stack and tr._stack[-1] is self, (
            f"span {self.name!r} closed out of LIFO order")
        tr._stack.pop()
        tr._commit(self)
        return False


def _record(device: torch.device):
    """A timing event recorded on ``device``'s current stream."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _stream_of(stream):
    """``Span.stream`` for a ``stream=`` argument (None, True or a
    device): None (a host span), ``"host"`` (the host is the stream) or a
    CUDA device."""
    if stream is None:
        return None
    if stream is True:
        if not torch.cuda.is_initialized():
            return "host"
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(stream)
    if device.type != "cuda":
        return "host"
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


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
        #: per CUDA device, the current ``(event, host stamp)`` anchor
        self._anchors: dict = {}
        #: closed stream spans on a card not yet resolved:
        #: ``(attrs, device, (anchor, enter event, exit event))``
        self._unresolved: list = []
        #: attrs dicts of closed spans that hold a lazy (tensor) value
        self._lazy: list[dict] = []

    def span(self, name: str, *, stream=None, **attrs) -> Span:
        return Span(self, name, attrs, _stream_of(stream))

    def count(self, key: str, n) -> None:
        """Add ``n`` to the counter ``key`` of the innermost open span, if
        that span opened one (``span(name, key=0)``)."""
        attrs = self._stack[-1].attrs if self._stack else {}
        if key in attrs:
            attrs[key] += n

    def _take_anchor(self, device: torch.device) -> tuple:
        """A new anchor on ``device``, whose stream must be idle: the host
        stamp taken as the event's record returns. The call creates the
        event first and can take 0.1 ms on the host; the idle card stamps
        the event a few microseconds after the call submits it, at its
        end, so an interval mapped through the anchor lies that much
        early, never late."""
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        host = self._clock()
        ev.synchronize()
        self._anchors[device] = anchor = (ev, host)
        return anchor

    def _anchor(self, device: torch.device) -> tuple:
        """The current anchor on ``device``; the first one waits for the
        stream to drain."""
        anchor = self._anchors.get(device)
        if anchor is None:
            torch.cuda.current_stream(device).synchronize()
            anchor = self._take_anchor(device)
        return anchor

    #: a tracer is a callable: ``with tracer("stage/x"):`` == ``.span``
    __call__ = span

    def _reserve(self) -> int:
        self._spans.append(None)
        return len(self._spans) - 1

    def _commit(self, sp: Span) -> None:
        if sp._events is not None:
            self._unresolved.append((sp.attrs, sp.stream, sp._events))
            sp._events = None
        elif sp.stream == "host":
            sp.attrs["device_t0"] = sp.t0
            sp.attrs["device_ms"] = 1e3 * sp.dur
        self._note_lazy(sp.attrs)
        self._spans[sp.index] = {
            "name": sp.name, "t0": sp.t0, "dur": sp.dur, "depth": sp.depth,
            "parent": sp.parent, "index": sp.index, "attrs": sp.attrs,
        }

    def _note_lazy(self, attrs: dict) -> None:
        if any(isinstance(v, torch.Tensor) for v in attrs.values()):
            self._lazy.append(attrs)

    def _resolve(self) -> None:
        """Put every closed stream span's interval on the host clock and
        read every lazy attribute back: one synchronize per device, one
        readback per device and dtype."""
        for device in {d for _, d, _ in self._unresolved}:
            torch.cuda.synchronize(device)
        for attrs, _, ((anchor, host), enter, leave) in self._unresolved:
            attrs["device_t0"] = host + anchor.elapsed_time(enter) / 1e3
            attrs["device_ms"] = enter.elapsed_time(leave)
        self._unresolved = []
        groups: dict = {}
        for attrs in self._lazy:
            for key, v in attrs.items():
                if isinstance(v, torch.Tensor):
                    groups.setdefault((v.device, v.dtype), []).append(
                        (attrs, key, v))
        for items in groups.values():
            values = torch.stack([v.reshape(()) for _, _, v in items])
            for (attrs, key, _), value in zip(items, values.tolist()):
                attrs[key] = value
        self._lazy = []

    def add(self, name: str, t0: float, dur: float, *, parent: int = -1,
            **attrs) -> None:
        """Record a synthetic closed span (a per-round child of a measured
        kernel span). ``parent`` is a closed span's ``index``."""
        depth = 0
        if 0 <= parent < len(self._spans) and self._spans[parent]:
            depth = self._spans[parent]["depth"] + 1
        self._note_lazy(attrs)
        self._spans.append({
            "name": name, "t0": t0, "dur": dur, "depth": depth,
            "parent": parent, "index": len(self._spans), "attrs": attrs,
        })

    def spans(self) -> list[dict]:
        """Closed spans, start-ordered (open spans are excluded), their
        stream intervals and lazy attributes resolved."""
        if self._unresolved or self._lazy:
            self._resolve()
        return [s for s in self._spans if s is not None]

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON object (``traceEvents`` complete
        events; microsecond timestamps; span attrs under ``args``). The
        stream spans' device intervals go on track 1, "card stream"."""
        events = [{
            "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
            "args": {"name": "repro.obs"},
        }]
        card = []
        for s in self.spans():
            events.append({
                "name": s["name"], "ph": "X", "pid": 0, "tid": 0,
                "ts": s["t0"] * 1e6, "dur": s["dur"] * 1e6,
                "args": {k: _jsonable(v) for k, v in s["attrs"].items()},
            })
            if "device_t0" in s["attrs"]:
                card.append({
                    "name": s["name"], "ph": "X", "pid": 0, "tid": 1,
                    "ts": s["attrs"]["device_t0"] * 1e6,
                    "dur": s["attrs"]["device_ms"] * 1e3,
                    "args": {"index": s["index"]},
                })
        if card:
            events += [{"name": "thread_name", "ph": "M", "pid": 0,
                        "tid": tid, "args": {"name": name}}
                       for tid, name in ((0, "host"), (1, "card stream"))]
        return {"traceEvents": events + card, "displayTimeUnit": "ms"}

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


NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every call is a no-op returning shared
    singletons."""

    enabled = False

    def span(self, name: str = "", **attrs) -> _NullSpan:
        return NULL_SPAN

    __call__ = span

    def add(self, *args, **kwargs) -> None:
        return None

    def count(self, key: str, n) -> None:
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
