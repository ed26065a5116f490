"""``segment_min``'s share of its byte roofline over the window.

One launch a request: the Euler tour's discovery times, keys over both
arcs of every slot of the tour's buffer, into ``n_bucket`` segments. The
shapes are not in the spans: the count takes the tour's buffer to be the
certificate's ``2(n_bucket - 1)`` slots where the ``stage/pipeline/<kind>``
span names a certificate, the full buffer (``cap``) where it names none,
and the live keys to be both arcs of a spanning forest of the graph (the
reference's ``forest_edges``). Bytes: ``roofline.segment_min_bytes``.
Time: the card's time in kernels named ``segment_min``. None unless the
launches counted are one per pipeline span."""
from cardbench.roofline import roofline_pct, segment_min_bytes
from cardbench.spanstats import pipeline_spans


def read(run):
    if run.trace is None:
        return None
    pipes = pipeline_spans(run)
    if not pipes or run.launches.get("segment_min", 0) != len(pipes):
        return None
    live = 2 * run.facts["forest_edges"]
    nbytes = 0
    for s in pipes:
        a = s["attrs"]
        slots = 2 * (a["n_bucket"] - 1) if a.get("certificate") else a["cap"]
        nbytes += segment_min_bytes(2 * slots, live, a["n_bucket"])
    return roofline_pct(nbytes, run.trace.kernel_s("segment_min"))
