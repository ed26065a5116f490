"""``torch.cuda.max_memory_allocated()`` over the program's set-up and the
window: the peak is reset once the cell's graph is made and its device
copy freed, and read when the window closes."""


def read(run):
    return run.peak_bytes
