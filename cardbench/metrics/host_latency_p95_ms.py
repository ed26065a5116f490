"""The exact 95th percentile (nearest rank) of every request's time in the
window, from its sending to its answer in the caller's hands: kept per
layer for cells whose tail is paced by the host's memory and spreads too
widely to be bounded end to end. Read in a traced run, so it is the tail
with the tracer on."""
from cardbench.percentiles import percentile


def read(run):
    if not run.latencies_s:
        return None
    return 1e3 * percentile(run.latencies_s, 95)
