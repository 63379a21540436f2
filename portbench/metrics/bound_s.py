"""Seconds a pair in the host's remaining-cost bound
(lower_bounds.compute_remaining_bound, from the engine and the batched
engine)."""


def read(run):
    spans = [s for s in run.spans if s[0] == "bounds.remaining_bound"]
    if not run.n_pairs or not spans:
        return None
    return sum(b - a for _, a, b, _ in spans) / 1e9 / run.n_pairs
