"""Opt-in device profiler capture (``repro.obs.profile``): the port's
counterpart of ``jax.profiler.trace`` is ``torch.profiler.profile``.

The span tracer times stages from the HOST side; this captures the
matching device-side timeline. While a capture runs, every tracer span
also opens a ``torch.profiler.record_function`` of its own name (the
reference labels its programs with ``jax.named_scope``), so the capture's
ranges carry the span names: one run, two views of the same stages.

Off by default and free when unused: the profiler starts only inside the
context manager, and spans open no ``record_function`` outside it.
"""
from __future__ import annotations

import contextlib
import os

import torch

from repro_torch.obs import tracer as _tracer


@contextlib.contextmanager
def profiler_trace(logdir):
    """``with profiler_trace(dir):`` captures a profile and, on exit,
    writes it as a Chrome trace (``trace.json``) into ``dir`` (open it in
    Perfetto or ``chrome://tracing``): CPU activity, and CUDA activity
    where a card is available. ``logdir=None`` disables it: the same code
    path stays a no-op, which is how command-line knobs thread it
    through."""
    if not logdir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was_on = _tracer._PROFILER_LABELS["on"]
    _tracer._PROFILER_LABELS["on"] = True
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield logdir
    finally:
        _tracer._PROFILER_LABELS["on"] = was_on
    prof.export_chrome_trace(os.path.join(str(logdir), "trace.json"))
