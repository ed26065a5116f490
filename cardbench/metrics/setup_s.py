"""Seconds from the start of the run's process (the first line of
``run.py``) to the sending of the first timed request: imports, CUDA's
start, the kernel library's build or load, the graph and the warm-up."""


def read(run):
    return run.setup_s
