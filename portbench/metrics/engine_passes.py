"""Engine passes a pair: the facade's calls of its engine (the K-scaled
tie-break runs a second pass where the first's rounds could hold a total
template-switch length of K or more)."""


def read(run):
    if not run.n_pairs:
        return None
    return sum(run.passes.values()) / run.n_pairs
