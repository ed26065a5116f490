"""Sums of the program's stream spans over a traced window, for the metric
readers.

A stream span (``repro_torch.obs``: opened with ``stream=``) carries the
interval in which the card's stream did its work, on the tracer's clock,
as ``attrs["device_t0"]`` (s) and ``attrs["device_ms"]``."""
from __future__ import annotations


def per_request_device_ms(run, match) -> float | None:
    """Milliseconds of the card's stream in the stream spans whose name
    ``match`` accepts, per request of the window; None where there is
    none."""
    ms = [s["attrs"]["device_ms"] for s in run.spans
          if match(s["name"]) and "device_ms" in s["attrs"]]
    if not ms or not run.attempted:
        return None
    return sum(ms) / run.attempted
