"""Share of the traced window in which no operation ran on the card:
100 x (1 - the union of the card's event intervals / the window)."""


def read(run):
    if run.trace is None:
        return None
    s = run.trace.summary()
    if not s["window_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
