"""torch.cuda.max_memory_allocated() over the window (reset at its start),
in GiB: the resident tables and what the served batches add."""


def read(run):
    return run.window_peak_bytes / 2 ** 30 if run.cuda else None
