"""Requests answered in the window, over the window's seconds (from the
first request's sending to the last answer)."""


def read(run):
    if not run.window_s:
        return None
    return (run.attempted - run.failed) / run.window_s
