"""The exact 95th percentile (nearest rank) of every request's time in the
window, from its sending to its answer in the caller's hands."""
from cardbench.percentiles import percentile


def read(run):
    if not run.latencies_s:
        return None
    return 1e3 * percentile(run.latencies_s, 95)
