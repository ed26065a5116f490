"""Certificate and device final of the 2-edge-connected labels on the
Graph 500 cell: ``stage/pipeline/2ecc`` per request (synced at its end).
Less ``final_ms``, it is the certificate's time on that cell."""
from cardbench.spanstats import per_request_ms


def read(run):
    return per_request_ms(run, ("stage/pipeline/2ecc",))
