"""peak_mem_gib: torch.cuda.max_memory_allocated() over the window,
after reset_peak_memory_stats() at its start, in GiB."""


def read(rec):
    return rec.window_peak_bytes / float(1 << 30)
