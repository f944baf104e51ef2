"""Peak device memory the program allocated in the window
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``),
GiB: what a user has to leave free on a card they share."""


def read(run):
    return run.memory_peak_bytes / 2 ** 30 if run.memory_peak_bytes else None
