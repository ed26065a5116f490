"""Result conversion (device buffers to the host's set): ``stage/convert``
per request."""
from cardbench.spanstats import per_request_ms


def read(run):
    return per_request_ms(run, ("stage/convert",))
