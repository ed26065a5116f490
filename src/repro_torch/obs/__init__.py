"""repro_torch.obs — the span tracer (``tracer.py``), the metrics
registry (``metrics.py``) and the profiler capture (``profile.py``) of
``repro.obs``.

The tracer is off by default: the module-level tracer is the no-op
``NULL_TRACER`` until ``enable_tracing()``; instrumented code always goes
through ``get_tracer()``, so flipping the switch needs no re-plumbing.

The spans of a one-shot call (``repro_torch.analyze``), and what reads
each (``cardbench/metrics/<name>.py``; "stream" marks a stream span, whose
``device_t0``/``device_ms`` give the card's interval, "synced" one that
waits for the card at its close):

* ``engine/analyze/<kind>``: the request; a container.
* ``stage/pad`` (``pad_ms``): the upload into the shape bucket's buffers;
  its child ``stage/pad/h2d`` (``bytes``: 8 a real edge;
  ``staged_bytes``: those of them sent through the card's pinned ring,
  ``h2d_staged_pct``) the two copies to the card and the fills of the
  bucket's tail (``h2d_copy_ms``).
* ``stage/pipeline/<kind>``, stream and synced (``pipeline_ms``,
  ``pipeline_ms.cuts``, the rooflines' shapes): the one-shot program.
  Inside it, each a stream span with no sync of its own:
  ``stage/tombstone`` (with ``delete=``),
  ``stage/certificate_build/<name>`` (``certificate_ms``: both forest
  passes and the compaction) and ``stage/final/<kind>`` (``final_ms``)
  with its child ``stage/tour`` (``tour_ms``: ``tour_state``).
* ``kernel/forest/<which>``, synced (the rooflines' passes): one forest
  pass, with ``edges`` (slots), ``n``, ``rounds`` and a lazy ``live``
  (its live non-loop slots), and one synthetic ``kernel/round/<which>``
  child a round (``round``); ``kernel/segment_min`` (``keys``,
  ``segments``, a lazy ``live``): one launch of that op.
* ``stage/convert`` (``convert_ms``): the device answer to the host's set.
* ``sync/<site>`` (``host_syncs_per_req`` counts them): every place the
  host waits for the card (``host_sync``): ``sync/round/boruvka`` and
  ``sync/round/sfs`` (a round loop's exit test), ``sync/h2d`` (a plain
  copy to the card, or a wait for a slot of the pinned ring),
  ``sync/convert`` (a copy of the answer to the host).

Other paths (the live engine, the batch, the merge, the scheduler) open
their own ``engine/*``, ``stage/*``, ``merge/*``, ``sched/*`` and
``recover/*`` spans; ``stage_rollup()`` bills the outermost ``stage/``,
``kernel/``, ``merge/`` and ``host/`` spans.
"""
from __future__ import annotations

from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_latency_buckets,
)
from repro_torch.obs.profile import profiler_trace
from repro_torch.obs.tracer import (
    NULL_SPAN,
    NULL_TRACER,
    STAGE_PREFIXES,
    NullTracer,
    Span,
    Tracer,
)

_TRACER: Tracer | NullTracer = NULL_TRACER
_METRICS = MetricsRegistry()


def get_tracer() -> Tracer | NullTracer:
    """The process-current tracer. Instrumented code calls this at use
    time (never caches it), so enabling tracing mid-process takes effect
    everywhere immediately."""
    return _TRACER


def enable_tracing(tracer: Tracer | None = None) -> Tracer:
    """Install (and return) a live tracer as the process tracer."""
    global _TRACER
    _TRACER = tracer if tracer is not None else Tracer()
    return _TRACER


def disable_tracing() -> None:
    """Back to the no-op tracer (collected spans are dropped with it
    unless the caller kept a reference)."""
    global _TRACER
    _TRACER = NULL_TRACER


def host_sync(site: str):
    """A context manager around one place where the host waits for the
    card (a readback, a plain copy, a slot of the pinned ring): while
    tracing, the span ``sync/<site>`` over the wait; otherwise a shared
    no-op, at the cost of one ``enabled`` check."""
    tr = _TRACER
    if tr.enabled:
        return tr.span("sync/" + site)
    return NULL_SPAN


def get_metrics() -> MetricsRegistry:
    """The process-global metrics registry (the engine's memory gauges)."""
    return _METRICS


def snapshot() -> dict:
    """One-call rollup of the global metrics registry."""
    return _METRICS.snapshot()


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "NULL_TRACER",
           "NullTracer", "STAGE_PREFIXES", "Span", "Tracer",
           "default_latency_buckets", "disable_tracing", "enable_tracing",
           "get_metrics", "get_tracer", "host_sync", "profiler_trace",
           "snapshot"]
