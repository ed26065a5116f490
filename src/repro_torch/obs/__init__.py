"""repro_torch.obs — the span tracer (``tracer.py``), the metrics
registry (``metrics.py``) and the profiler capture (``profile.py``) of
``repro.obs``.

The tracer is off by default: the module-level tracer is the no-op
``NULL_TRACER`` until ``enable_tracing()``; instrumented code always goes
through ``get_tracer()``, so flipping the switch needs no re-plumbing.
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


def get_metrics() -> MetricsRegistry:
    """The process-global metrics registry (the engine's memory gauges)."""
    return _METRICS


def snapshot() -> dict:
    """One-call rollup of the global metrics registry."""
    return _METRICS.snapshot()


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "NULL_TRACER",
           "NullTracer", "STAGE_PREFIXES", "Span", "Tracer",
           "default_latency_buckets", "disable_tracing", "enable_tracing",
           "get_metrics", "get_tracer", "profiler_trace", "snapshot"]
