"""device_peak_gib: the allocator's peak of card memory over the window
(``torch.cuda.max_memory_allocated()`` after a reset at its start), GiB."""


def read(run):
    return run.window_peak_bytes / 2**30 if run.window_peak_bytes else None
