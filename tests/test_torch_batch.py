"""The port's batched engine against the JAX package's (tolerance 0).

``tsalign_tpu_torch.parallel.batch_ts.BatchedTSAligner(device="cpu")``
against ``tsalign_tpu.parallel.batch_ts.BatchedTSAligner`` on the CPU (its
host rounds loop, ``_align_host``): per pair the cost, the rounds, every kept
primary and reentry field and the traced alignment, over a flankless random
config, a flanked one and a binding-window one, in batches of 1, 3 and 8
pairs of unequal lengths (every pair but the longest poison-padded into the
bucket).  ``align_pairs`` against the JAX ``align_pairs``: the TOML records,
record by record (all but their wall times), over one bucket, several
buckets and more than 8 pairs (the split into sub-batches), and a rewinding
config, whose records the K-scaled tie-break may send through the redo pass.
"""

import numpy as np
import pytest

from tsalign_tpu.alphabet import get_alphabet
from tsalign_tpu.parallel import batch_ts as jax_batch
from tsalign_tpu_torch.convert import config_from_reference
from tsalign_tpu_torch.parallel import batch_ts as port_batch

from torch_util import one_torch_thread  # noqa: F401
from util import binding_window_config, random_config, related_pair_scaled


def _config(kind, rng, al):
    if kind == "flankless":
        return random_config(rng, al, flanks=False)
    if kind == "flanked":
        cfg = random_config(rng, al, flanks=True)
        cfg.left_flank_length, cfg.right_flank_length = 2, 1
        return cfg
    return binding_window_config(rng, al, 1, 2)


def _pairs(rng, al, n_pairs, lo=20, hi=40):
    """Pairs of unequal lengths in [lo, hi] (one of them hi long)."""
    lengths = [hi] + [int(rng.integers(lo, hi)) for _ in range(n_pairs - 1)]
    rng.shuffle(lengths)
    return [related_pair_scaled(rng, al, n, int(rng.integers(5, 9))) for n in lengths]


@pytest.mark.parametrize("n_pairs", [1, 3, 8])
@pytest.mark.parametrize("kind", ["flankless", "flanked", "binding_window"])
def test_batched_engine_matches_jax(kind, n_pairs):
    rng = np.random.default_rng(700 + 10 * n_pairs + len(kind))
    al = get_alphabet("dna")
    cfg = _config(kind, rng, al)
    pairs = _pairs(rng, al, n_pairs)
    want_bt = jax_batch.BatchedTSAligner(cfg, pairs, chunk=16, keep_fields=True)
    got_bt = port_batch.BatchedTSAligner(config_from_reference(cfg), pairs, chunk=16,
                                         keep_fields=True, device="cpu")
    want, got = want_bt._align_host(), got_bt.align()
    assert len(got) == len(want) == n_pairs
    for w, g in zip(want, got):
        assert (g.cost, g.rounds) == (w.cost, w.rounds)
        assert len(g.primary_fields) == len(w.primary_fields)
        assert len(g.reentry_fields) == len(w.reentry_fields)
        for a, b in zip(g.primary_fields, w.primary_fields):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(g.reentry_fields, w.reentry_fields):
            np.testing.assert_array_equal(a, b)
    assert got_bt.sdel_budget == want_bt.sdel_budget
    # the traceback over the lazy device views, pair by pair
    got_bt = port_batch.BatchedTSAligner(config_from_reference(cfg), pairs, chunk=16,
                                         device="cpu")
    want_bt = jax_batch.BatchedTSAligner(cfg, pairs, chunk=16, keep_fields=True)
    want_bt.align = want_bt._align_host
    traced = got_bt.align_with_traceback()
    for (cw, aw), (cg, ag) in zip(want_bt.align_with_traceback(), traced):
        assert cg == cw and str(ag) == str(aw)
    assert [r.rounds for r in got_bt.last_results] == [r.rounds for r in want_bt.last_results]


def _record(rec):
    return "\n".join(
        line for line in rec.to_toml().splitlines()
        if not line.startswith(("duration_seconds", "runtime"))
    )


def _string_pairs(rng, lengths):
    letters = "ACGT"
    out = []
    for n in lengths:
        r = "".join(letters[c] for c in rng.integers(0, 4, size=n))
        q = list(r)
        for _ in range(2):
            q[int(rng.integers(0, n))] = letters[int(rng.integers(0, 4))]
        a = int(rng.integers(2, n - 8))
        comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
        q[a : a + 6] = [comp[c] for c in q[a : a + 6]][::-1]
        out.append((r, "".join(q)))
    return out


def _jax_align_pairs(cfg, pairs, names):
    """The JAX package's align_pairs on its host rounds loop (the CPU default)."""
    return jax_batch.align_pairs(cfg, pairs, names=names)


@pytest.mark.parametrize("case", ["one_bucket", "two_buckets", "split_of_ten"])
def test_align_pairs_matches_jax_records(case):
    rng = np.random.default_rng({"one_bucket": 81, "two_buckets": 82, "split_of_ten": 83}[case])
    al = get_alphabet("dna")
    cfg = random_config(rng, al, flanks=False)
    lengths = {"one_bucket": [14, 20, 26], "two_buckets": [12, 70, 18, 66],
               "split_of_ten": [int(n) for n in rng.integers(12, 30, size=10)]}[case]
    pairs = _string_pairs(rng, lengths)
    names = [(f"R{i}", f"Q{i}") for i in range(len(pairs))]
    want = _jax_align_pairs(cfg, pairs, names)
    got = port_batch.align_pairs(config_from_reference(cfg), pairs, names=names, device="cpu")
    assert len(got) == len(want) == len(pairs)
    for g, w in zip(got, want):
        assert _record(g) == _record(w)


def test_align_pairs_rewinding_config_matches_jax_records():
    """A config whose negative anti-primary gaps let a path rewind: the
    K-scaled tie-break checks each pair's rounds against K."""
    rng = np.random.default_rng(90)
    al = get_alphabet("dna")
    while True:
        cfg = random_config(rng, al, flanks=False)
        if cfg.can_rewind():
            break
    pairs = _string_pairs(rng, [16, 22])
    want = _jax_align_pairs(cfg, pairs, None)
    got = port_batch.align_pairs(config_from_reference(cfg), pairs, device="cpu")
    for g, w in zip(got, want):
        assert _record(g) == _record(w)


def test_align_pairs_redo_pass_matches_the_single_pair_path():
    """The redo pass: a pair whose rounds could let the TS length reach K
    is aligned again through the single-pair facade's engine.  Forced here by
    reporting a huge round count for every pair of a rewinding config; each
    record then equals the JAX facade's cost and CIGAR.  (The JAX package's
    own redo pass passes no primaries to the single-pair engine and raises;
    the port passes both.)"""
    from tsalign_tpu.aligner import Aligner as JaxFacade

    rng = np.random.default_rng(91)
    al = get_alphabet("dna")
    while True:
        cfg = random_config(rng, al, flanks=False)
        if cfg.can_rewind():
            break
    pairs = _string_pairs(rng, [16, 22])
    batches = []

    def on_batch(idx, bt):
        batches.append(idx)
        for res in bt.last_results:
            res.rounds = 10**6

    got = port_batch.align_pairs(config_from_reference(cfg), pairs, device="cpu",
                                 on_batch=on_batch)
    assert batches == [[0, 1]]
    for (r, q), rec in zip(pairs, got):
        want = JaxFacade(costs=cfg, engine="jax").align(r, q).result
        assert rec.has_target == want.has_target
        if want.has_target:
            assert (rec.result.cost, rec.cigar()) == (want.result.cost, want.cigar())


def test_batch_fixture_holds_the_smokes_pairs():
    """tests/fixtures/torch_port_batch_pairs.json (recorded from the JAX
    align_pairs by scripts/make_torch_port_fixture.py) holds the planted pairs
    of chip_smoke.BATCH_FIXTURE_PAIRS in two buckets; smoke phase 7 holds the
    port's records on the card against it."""
    import json
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from chip_smoke import BATCH_FIXTURE, BATCH_FIXTURE_PAIRS, planted_pair

    with open(BATCH_FIXTURE) as f:
        pairs = json.load(f)["pairs"]
    assert [(p["name"], p["seed"], len(p["reference"]), p["ts_len"], p["snps"])
            for p in pairs] == [tuple(spec) for spec in BATCH_FIXTURE_PAIRS]
    for p in pairs:
        r, q = planted_pair(np.random.default_rng(p["seed"]), len(p["reference"]),
                            p["ts_len"], p["snps"], True)
        assert (r, q) == (p["reference"], p["query"])
    buckets = {(port_batch._bucket(len(p["reference"])), port_batch._bucket(len(p["query"])))
               for p in pairs}
    assert buckets == {(64, 64), (128, 128)}
