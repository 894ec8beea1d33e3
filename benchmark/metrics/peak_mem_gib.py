"""torch.cuda.max_memory_allocated over the window, after a reset at its
start: the program's own memory and the request it serves (the answers
kept for the check are moved to host memory as each request returns)."""

UNIT = "GiB"


def read(run):
    return run.peak_mem_bytes / 2 ** 30
