"""``boruvka_round``'s share of its byte roofline over the window.

Bytes: ``roofline.boruvka_round_bytes`` for every round, with each
Borůvka pass's slots and rounds read from the program's
``kernel/forest/boruvka`` spans and its vertices from the
``stage/pipeline/<kind>`` span's ``n_bucket``. The live slots of a pass
are not in the spans: the count takes ``min(slots, the request's edge
count)``, exact for the first pass over the full buffer and at most the
second pass's forest (n - 1 slots) or a certificate's unused slots too
high. Time: the card's time in kernels named ``boruvka_round``. None
unless the spans' rounds add up to the launches counted."""
from cardbench.roofline import boruvka_round_bytes, roofline_pct
from cardbench.spanstats import pipeline_spans


def read(run):
    if run.trace is None:
        return None
    passes = [s for s in run.spans if s["name"] == "kernel/forest/boruvka"]
    pipes = pipeline_spans(run)
    rounds = sum(s["attrs"].get("rounds", 0) for s in passes)
    if not passes or not pipes or \
            rounds != run.launches.get("boruvka_round", 0):
        return None
    n = pipes[0]["attrs"]["n_bucket"]
    edges = run.facts["n_edges"]
    nbytes = sum(s["attrs"]["rounds"] * boruvka_round_bytes(
        s["attrs"]["edges"], n, min(s["attrs"]["edges"], edges))
        for s in passes)
    return roofline_pct(nbytes, run.trace.kernel_s("boruvka_round"))
