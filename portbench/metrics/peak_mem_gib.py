"""The card's allocated memory at its peak in the window
(torch.cuda.max_memory_allocated after a reset at the window's start)."""


def read(run):
    if not run.peak_bytes:
        return None
    return run.peak_bytes / 2**30
