"""The one-shot entry's copy of the edge arrays to the card, apart from the
pad: ``stage/pad/h2d`` (host clock) per request."""
from cardbench.spanstats import per_request_ms


def read(run):
    return per_request_ms(run, ("stage/pad/h2d",))
