"""The 95th percentile of the wall of one call over all pairs of the window
(statistics.quantiles, exclusive method); needs twenty pairs or more."""

import statistics


def read(run):
    if len(run.walls) < 20:
        return None
    return statistics.quantiles(run.walls, n=20)[-1]
