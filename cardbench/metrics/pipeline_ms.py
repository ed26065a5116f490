"""Certificate and device final of the bridge analysis:
``stage/pipeline/bridges`` per request (synced at its end)."""
from cardbench.spanstats import per_request_ms


def read(run):
    return per_request_ms(run, ("stage/pipeline/bridges",))
