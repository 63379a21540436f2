"""The general generator of twin pairs: a random reference and a query copied
from it with exact counts of edits, read from a traffic file.

Frozen from ``chip_smoke.py::planted_pair`` (commit a358c37), with exact
counts where that draws rates: the stretches, substitutions, deletions and
insertions of a pair are always as many as the traffic file says, at
distinct positions, so that every pair of a cell has one structure and the
seed moves only the bases and the positions.

Traffic file keys: ``length`` (reference bases), ``stretches`` (a list of
``{"count", "length"}``: reverse-complement stretches planted in the query,
each at least ``margin`` bases from either end and apart from each other),
``substitutions``, ``deletions`` and ``insertions`` (single bases, outside
the stretches and at distinct positions), ``warmup_calls`` and ``pool``
(how many pairs set-up makes for the window).
"""

from __future__ import annotations

import numpy as np

ALPHABET = "ACGT"
COMPLEMENT = np.array([3, 2, 1, 0], dtype=np.int8)  # A<->T, C<->G
LETTERS = np.frombuffer(ALPHABET.encode(), dtype=np.uint8)

# Independent streams of one seed: the warm-up, the window and the sample
# of records that the check compares never share a draw.
WARMUP, WINDOW, SAMPLE = 1, 2, 3


def stream(seed: int, which: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**64 - 1), which])


def plan(rng: np.random.Generator, t: dict) -> dict:
    """The bases and edit positions of one pair built to `t`."""
    n = int(t["length"])
    margin = int(t.get("margin", 0))
    ref = rng.integers(0, 4, size=n).astype(np.int8)
    taken = np.zeros(n, dtype=bool)
    stretches = []
    for group in t.get("stretches", []):
        L = int(group["length"])
        for _ in range(int(group["count"])):
            # a start that keeps one free base between stretches
            free = ~np.convolve(taken, np.ones(L + 2, dtype=int), mode="full")[L:][:n].astype(bool)
            starts = np.flatnonzero(free[margin:n - margin - L + 1]) + margin
            if not starts.size:
                raise ValueError(f"no room for a {L}-base stretch in {n} bases")
            a = int(starts[int(rng.integers(0, starts.size))])
            stretches.append((a, L))
            taken[a:a + L] = True
    n_sub, n_del, n_ins = (int(t.get(k, 0)) for k in ("substitutions", "deletions", "insertions"))
    free = np.flatnonzero(~taken)
    if n_sub + n_del + n_ins > free.size:
        raise ValueError("more single-base edits than free positions")
    picks = rng.choice(free, size=n_sub + n_del + n_ins, replace=False)
    subs = {int(k): int(rng.integers(1, 4)) for k in picks[:n_sub]}
    ins = {int(k): int(rng.integers(0, 4)) for k in picks[n_sub + n_del:]}
    return {"ref": ref, "stretches": stretches, "subs": subs,
            "dels": sorted(int(k) for k in picks[n_sub:n_sub + n_del]), "ins": ins}


def apply(p: dict):
    """(reference, query) strings of a plan: the stretches reverse-complemented,
    a substitution shifts its base by 1-3, an insertion puts its base before
    the reference base at its position, a deletion drops that base."""
    ref = p["ref"]
    qry = ref.copy()
    for a, L in p["stretches"]:
        qry[a:a + L] = COMPLEMENT[ref[a:a + L]][::-1]
    if p["subs"]:
        k = np.fromiter(p["subs"], dtype=np.int64)
        qry[k] = (qry[k] + np.fromiter(p["subs"].values(), dtype=np.int8)) % 4
    if p["ins"]:  # before deleting: positions are the reference's
        k = np.fromiter(p["ins"], dtype=np.int64)
        keep = np.ones(len(ref), dtype=bool)
        keep[p["dels"]] = False
        order = np.argsort(k)
        qry = np.insert(qry, k[order], np.fromiter(p["ins"].values(), dtype=np.int8)[order])
        keep = np.insert(keep, k[order], True)
        qry = qry[keep]
    else:
        qry = np.delete(qry, p["dels"])
    return LETTERS[ref].tobytes().decode(), LETTERS[qry].tobytes().decode()


def twin(rng: np.random.Generator, t: dict):
    """One (reference, query) pair of strings built to `t`."""
    return apply(plan(rng, t))


def pairs(seed: int, which: int, count: int, t: dict):
    return Pairs(seed, which, t, count)[:count]


class Pairs:
    """The pairs of one stream of a seed, made `count` at a time: set-up
    makes the traffic's `pool`, and a window that reads past it calls
    `extend`.  The k-th pair of a seed is the same however it was made."""

    def __init__(self, seed: int, which: int, t: dict, count: int):
        self.rng = stream(seed, which)
        self.t = t
        self.made = []
        self.extend(count)

    def extend(self, count: int) -> None:
        self.made.extend(twin(self.rng, self.t) for _ in range(count))

    def __len__(self):
        return len(self.made)

    def __getitem__(self, k):
        return self.made[k]
