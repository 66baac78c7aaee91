"""`torch.cuda.max_memory_allocated()` over set-up, warm-up and window,
after `reset_peak_memory_stats()` at the start of the run, in GiB."""

NAME = "peak_mem_gib"
UNIT = "GiB"
LAYER = "end to end"
MOVES = "peak_mem_gib"
SOURCE = "host_clock"


def read(ctx):
    return ctx["peak_bytes"] / 2**30 if ctx["peak_bytes"] else None
