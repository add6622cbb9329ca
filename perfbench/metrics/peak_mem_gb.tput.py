"""Peak bytes the caching allocator held on the card over the run, in GB."""


def read(run):
    return run.memory_peak_bytes / 1e9 if run.memory_peak_bytes else None
