"""peak_mem_gib: torch.cuda.max_memory_allocated over the window (the
statistics reset at its start), in GiB."""


def read(r):
    return r.window_peak / 2 ** 30 if r.window_peak else None
