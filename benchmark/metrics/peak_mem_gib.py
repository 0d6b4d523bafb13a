"""The caching allocator's peak over the program's set-up and the window,
graph pools included (`torch.cuda.max_memory_allocated`), in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30
