"""Rounds of the rounds loop a pair (EngineResult.rounds of the pair's last
engine pass, the one whose answer the facade keeps)."""


def read(run):
    last = [r[-1] for r in run.rounds.values() if r]
    if not last:
        return None
    return sum(last) / len(last)
