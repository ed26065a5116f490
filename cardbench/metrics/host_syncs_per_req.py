"""Places where the host waited for the card, per request: the program's
``sync/<site>`` spans (the round loops' exit tests, the pageable copies,
the answer's copies back); None where there is none."""


def read(run):
    n = sum(1 for s in run.spans if s["name"].startswith("sync/"))
    if not n or not run.attempted:
        return None
    return n / run.attempted
