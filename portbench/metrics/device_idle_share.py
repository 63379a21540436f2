"""The share of the traced window in which the card ran nothing (the union
of the device's kernel and copy intervals in torch.profiler's trace)."""


def read(run):
    if run.window_s <= 0 or run.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
