"""The card's milliseconds a request: the union of the card's busy
intervals in the window (``devtrace``), over the requests of the window.
What an answer costs of the card, at whatever pace the host feeds it;
None off the card."""


def read(run):
    if run.trace is None or not run.attempted:
        return None
    return 1e3 * run.trace.busy_s() / run.attempted
