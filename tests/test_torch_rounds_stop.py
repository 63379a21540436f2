"""The rounds loops' k * delta stop under the maximise tie-break, and the
facade's check of K.

The K-scaled engines minimise K * cost - total template-switch length, and a
rounds loop stops at round k once k * delta exceeds the incumbent, delta the
least value one more template switch adds (``numpy_engine.rounds_stop_delta``).
Under the default config the length cost caps no length, so delta caps each
switch's length bonus at max(n_r, n_q).  Held here against the benchmark's
plain reference (``portbench/reference/dp.py``): the witness pair, whose best
record needs a second switch at the same cost, through every loop; tiny
twins through every engine; the helper's value; and the facade's one pass,
and its second where a record's length reaches K.
"""

import numpy as np
import pytest

import tsalign_tpu_torch
from tsalign_tpu_torch import tracing
from tsalign_tpu_torch.alignment import Alignment
from tsalign_tpu_torch.numpy_engine import kdelta_stop, min_tsm_cost_bound, rounds_stop_delta

from torch_util import cost_and_ts_length, one_torch_thread, reference_optimum  # noqa: F401

WITNESS = ("GAGCTTAAGCACAGGCCTGGGC", "GAGTGCTTAACAAGCCTGGGC")


def _default():
    return tsalign_tpu_torch.TemplateSwitchConfig.default(tsalign_tpu_torch.get_alphabet("dna-n"))


def _twin(seed, n=24, stretch=7):
    """A random reference of n bases and a query with `stretch` bases
    reverse-complemented in place (at least 4 from either end), one
    substitution and one deletion elsewhere."""
    rng = np.random.default_rng(seed)
    r = list(rng.choice(list("ACGT"), n))
    a = int(rng.integers(4, n - 4 - stretch + 1))
    q = r[:a] + [{"A": "T", "C": "G", "G": "C", "T": "A"}[c] for c in r[a:a + stretch][::-1]]
    q += r[a + stretch:]
    outside = [i for i in range(n) if not a <= i < a + stretch]
    s, d = rng.choice(outside, 2, replace=False)
    q[s] = "ACGT"[("ACGT".index(q[s]) + int(rng.integers(1, 4))) % 4]
    del q[d]
    return "".join(r), "".join(q)


TWINS = [_twin(seed) for seed in range(10)]


def _single(engine, r, q):
    if engine == "numpy":
        return tsalign_tpu_torch.Aligner(engine="numpy").align(r, q)
    return tsalign_tpu_torch.Aligner(device="cpu", fused=engine == "fused").align(r, q)


def test_the_witness_needs_two_switches():
    assert reference_optimum(*WITNESS) == (4, 13)


@pytest.mark.parametrize("engine", ["host", "fused", "numpy"])
def test_the_witness_through_align(engine):
    res = _single(engine, *WITNESS)
    assert cost_and_ts_length(res) == (4, 13)
    assert res.stats()["template_switch_amount"] == 2


def test_the_witness_through_align_pairs_on_the_fused_loop():
    (rec,) = tsalign_tpu_torch.align_pairs(_default(), [WITNESS], device="cpu", fused=True)
    assert (rec.cost, rec.alignment.ts_total_length()) == (4, 13)


@pytest.mark.parametrize("engine", ["host", "fused", "numpy"])
def test_tiny_twins_have_the_reference_optimum(engine):
    got = [cost_and_ts_length(_single(engine, r, q)) for r, q in TWINS]
    assert got == [reference_optimum(r, q) for r, q in TWINS]


def test_the_witness_and_tiny_twins_through_align_pairs():
    """One batch on the host loop (the batch pads each pair to 64 bases)."""
    pairs = [WITNESS] + TWINS[:6]
    recs = tsalign_tpu_torch.align_pairs(_default(), pairs, device="cpu", fused=False)
    got = [(rec.cost, rec.alignment.ts_total_length()) for rec in recs]
    assert got == [(4, 13)] + [reference_optimum(r, q) for r, q in pairs[1:]]


def test_the_stop_value():
    """At 160 bp and K = 512 the default config's delta is 2K - 160 (the
    least switch costs 2); a finite length cap below the pair's length keeps
    `min_tsm_cost_bound`, and one above it gives way to the pair's length."""
    cfg = _default()
    scaled = cfg.scaled_for_length_tiebreak(512)
    assert min_tsm_cost_bound(cfg) == 2 and min_tsm_cost_bound(scaled) == 2 * 512
    assert rounds_stop_delta(scaled, 160, 159) == 2 * 512 - 160
    assert rounds_stop_delta(scaled, 100, 160) == 2 * 512 - 160
    assert rounds_stop_delta(cfg, 160, 159) == 2  # no bonus, no cap
    capped = _with_length_cap(scaled, 30)
    assert capped.length_costs.maximum_finite_input() == 30
    assert rounds_stop_delta(capped, 160, 159) == min_tsm_cost_bound(capped) == 2 * 512 - 30
    assert rounds_stop_delta(capped, 20, 19) == 2 * 512 - 20
    assert kdelta_stop(3, 864, 2591) and not kdelta_stop(3, 864, 2592)
    assert not kdelta_stop(5, 0, -1)


def _with_length_cap(cfg, lmax):
    """`cfg` with lengths above `lmax` infinitely costly."""
    from dataclasses import replace

    from tsalign_tpu_torch.costs import INF, CostFunction

    pts = [(x, c) for x, c in cfg.length_costs.points if x <= lmax] + [(lmax + 1, INF)]
    return replace(cfg, length_costs=CostFunction(pts))


def test_one_facade_pass_where_the_record_is_shorter_than_k():
    """The witness's record (13 bases) is far below K = 64: one pass."""
    tracing.take()
    tracing.enable()
    try:
        res = tsalign_tpu_torch.align(*WITNESS, device="cpu")
    finally:
        tracing.disable()
    _, counts = tracing.take()
    (per_call,) = counts.values()
    assert per_call["facade.engine_passes"] == 1 and cost_and_ts_length(res) == (4, 13)


def test_a_record_as_long_as_k_runs_a_second_pass(monkeypatch):
    """Where a pass's record reaches K, K doubles past its length and the
    engine runs again; the answer is the second pass's."""
    seen = []
    real = Alignment.ts_total_length

    def reported(self):
        n = real(self)
        seen.append(n)
        return 64 if len(seen) == 1 else n  # the first pass's record as long as K

    monkeypatch.setattr(Alignment, "ts_total_length", reported)
    ks = []
    aligner = tsalign_tpu_torch.Aligner(device="cpu")
    raw = aligner._run_engine_raw

    def run(cfg, *a, **k):
        ks.append(cfg.base_cost["rqr"] // 2)
        return raw(cfg, *a, **k)

    monkeypatch.setattr(aligner, "_run_engine_raw", run)
    res = aligner.align(*WITNESS)
    assert ks == [64, 128]
    monkeypatch.undo()
    assert cost_and_ts_length(res) == (4, 13)
