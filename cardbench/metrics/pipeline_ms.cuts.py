"""The vertex kinds' device final on the full buffer:
``stage/pipeline/cuts`` per request (synced at its end)."""
from cardbench.spanstats import per_request_ms


def read(run):
    return per_request_ms(run, ("stage/pipeline/cuts",))
