"""Entry and pad: ``stage/pad`` per request (the pageable host-to-card
copy of the edge arrays and the pad to a power of two)."""
from cardbench.spanstats import per_request_ms


def read(run):
    return per_request_ms(run, ("stage/pad",))
