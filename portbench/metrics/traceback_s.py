"""Seconds a pair in the traceback (TracebackEngine.trace, host numpy over
the fields kept on the device)."""


def read(run):
    spans = [s for s in run.spans if s[0] == "traceback.trace"]
    if not run.n_pairs or not spans:
        return None
    return sum(b - a for _, a, b, _ in spans) / 1e9 / run.n_pairs
