"""Sums of the program's tracer spans over a traced window, for the
metric readers."""
from __future__ import annotations


def total_s(run, names) -> float | None:
    """Seconds of the spans named in ``names``; None where there is none."""
    durations = [s["dur"] for s in run.spans if s["name"] in names]
    return sum(durations) if durations else None


def per_request_ms(run, names) -> float | None:
    """Milliseconds of the spans named in ``names``, per request of the
    window; None where there is none."""
    total = total_s(run, names)
    if total is None or not run.attempted:
        return None
    return 1e3 * total / run.attempted


def pipeline_spans(run) -> list:
    """The one-shot pipeline's dispatch spans (``stage/pipeline/<kind>``)."""
    return [s for s in run.spans if s["name"].startswith("stage/pipeline/")]
