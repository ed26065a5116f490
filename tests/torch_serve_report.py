"""The serving driver's report (``launch/serve_bridges.py::main``) with
every value the clock decides taken out, so that two runs of one argv can
be held equal: ``repro``'s against the port's on the CPU, or the port's on
the card against the port's on the CPU. Imports neither JAX nor torch.

What goes: seconds (keys ending in ``_s``), rates (``*qps``, ``*_per_s``),
a histogram's ``sum``/``min``/``max``/``mean`` and percentiles, a gauge's
``updated_at``, ``speedup``, ``p99_spread``, and paths (``path``,
``ckpt_dir``). A value that goes becomes ``"clock"``, or stays ``None``
where it was ``None``, so that a rate that exists on one side only still
shows. What stays: every count, counter and answer-derived value, the
histograms' ``count``s among them. ``jain_qps`` goes too; the tests hold it
apart within 1e-12 (every tenant's rate shares one wall, so it depends on
the counts alone). The top-level ``trace`` section goes: the port's union
pass has stages of its own, so its span and stage counts differ by design;
the tests hold the trace's span names apart.
"""
import json
import re
from collections import Counter

#: leaf keys whose values the clock decides
CLOCK_KEYS = frozenset({"sum", "min", "max", "mean", "p50", "p95", "p99",
                        "speedup", "p99_spread", "updated_at", "path",
                        "ckpt_dir"})

#: the reference's ``kernel_path`` records for the port's: the plain
#: version on the CPU is the port's ``ref``
KERNEL_PATHS = {"oracle": "ref"}


def is_clock(key) -> bool:
    key = str(key)
    return (key in CLOCK_KEYS or key.endswith(("_s", "qps", "_per_s")))


def clock_free(report, kernel_path: str | None = None):
    """A copy of ``report`` without the clock's values (module docstring).
    ``kernel_path`` replaces every ``kernel_path`` record where given (a
    card run against a CPU run); otherwise ``oracle`` reads ``ref``."""
    def walk(obj, key=None):
        if isinstance(obj, dict):
            return {k: ((None if v is None else "clock")
                        if is_clock(k) and not isinstance(v, dict)
                        else walk(v, k))
                    for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [walk(v) for v in obj]
        if key == "kernel_path":
            return kernel_path or KERNEL_PATHS.get(obj, obj)
        return obj

    return walk({k: v for k, v in report.items() if k != "trace"})


def jain(report):
    """The multitenant report's ``jain_qps``."""
    return report["multitenant"]["fairness"]["jain_qps"]


_CLOCK_TEXT = [(re.compile(r"[\d,]+ edges/s"), "# edges/s"),
               (re.compile(r"\d+\.\d+"), "#"),
               (re.compile(r"\d+ms"), "#ms")]


def clock_free_lines(text: str) -> list:
    """The driver's printed lines with every decimal number, every
    ``<n>ms`` and the edges-per-second rate replaced by ``#``, and the
    reference's ``kernel_path=oracle`` read as ``ref``."""
    text = text.replace("kernel_path=oracle", "kernel_path=ref")
    for pattern, repl in _CLOCK_TEXT:
        text = pattern.sub(repl, text)
    return [line for line in text.splitlines() if line.strip()]


def span_names(path) -> Counter:
    """Span names under ``serve/``, ``sched/`` and ``engine/`` of a Chrome
    trace file (``--trace-out``), with their counts."""
    with open(path) as f:
        trace = json.load(f)
    return Counter(ev["name"] for ev in trace["traceEvents"]
                   if ev.get("ph") == "X"
                   and ev["name"].startswith(("serve/", "sched/", "engine/")))
