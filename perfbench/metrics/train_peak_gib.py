"""``torch.cuda.max_memory_allocated()`` over the window, the statistics
reset at its start (so weights and optimizer state are in it), in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30
