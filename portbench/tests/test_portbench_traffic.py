"""The generator: the same seed gives the same pairs, and every pair holds
exactly the edits its traffic file states."""

import json
import os

import numpy as np
import pytest

from harness import cells, traffic

TRAFFIC = sorted(f[:-5] for f in os.listdir(os.path.join(cells.BENCH_DIR, "traffic")))
BIG_SEED = 2**31 + 987654321


def load(name):
    with open(os.path.join(cells.BENCH_DIR, "traffic", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", TRAFFIC)
def test_same_seed_same_pairs(name):
    t = load(name)
    a = traffic.pairs(BIG_SEED, traffic.WINDOW, 20, t)
    assert a == traffic.pairs(BIG_SEED, traffic.WINDOW, 20, t)
    assert a != traffic.pairs(BIG_SEED + 1, traffic.WINDOW, 20, t)
    assert a != traffic.pairs(BIG_SEED, traffic.WARMUP, 20, t)


@pytest.mark.parametrize("name", TRAFFIC)
def test_exact_counts(name):
    t = load(name)
    rng = traffic.stream(BIG_SEED, traffic.WINDOW)
    n = t["length"]
    for _ in range(200):
        p = traffic.plan(rng, t)
        ref, qry = traffic.apply(p)
        assert len(ref) == n
        assert len(qry) == n - t["deletions"] + t["insertions"]
        want = sorted(g["length"] for g in t["stretches"] for _ in range(g["count"]))
        assert sorted(L for _, L in p["stretches"]) == want
        marked = np.zeros(n, dtype=int)
        for a, L in p["stretches"]:
            assert t["margin"] <= a and a + L <= n - t["margin"]
            marked[a:a + L] += 1
        edits = list(p["subs"]) + p["dels"] + list(p["ins"])
        assert len(p["subs"]) == t["substitutions"] and len(p["dels"]) == t["deletions"]
        assert len(p["ins"]) == t["insertions"]
        assert len(set(edits)) == len(edits) and not marked[edits].any()
        assert marked.max() <= 1
        # without deletions and insertions the query differs where the plan says
        if not p["dels"] and not p["ins"]:
            diff = {k for k in range(n) if ref[k] != qry[k]}
            assert set(p["subs"]) <= diff


def test_plan_applies_as_stated():
    p = {"ref": np.array([0, 1, 2, 3, 0, 1], dtype=np.int8), "stretches": [(1, 3)],
         "subs": {5: 2}, "dels": [4], "ins": {0: 3}}
    ref, qry = traffic.apply(p)
    assert ref == "ACGTAC"
    # T inserted, A, rc(CGT) = ACG, (A deleted), C shifted by 2 -> T
    assert qry == "TAACGT"


def test_pairs_made_later_are_the_same():
    t = load("twin160")
    made = traffic.Pairs(BIG_SEED, traffic.WINDOW, t, 3)
    made.extend(4)
    assert made[:7] == traffic.pairs(BIG_SEED, traffic.WINDOW, 7, t)
