"""Requests answered in the window over its seconds, as
``requests_per_s`` reads them, kept per layer for cells whose rate is
paced by the host's memory and spreads too widely to be bounded end to
end. Read in a traced run, so it is the rate with the tracer on."""


def read(run):
    if not run.window_s:
        return None
    return (run.attempted - run.failed) / run.window_s
