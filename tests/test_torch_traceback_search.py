"""The traceback's array search for the template switch behind a reentry
(``traceback.TracebackEngine._reconstruct_tsm``) against the loop over every
(kind, l, ldiff) candidate that it replaced, kept here as the reference.

  * every reentry of each traced record: the array search returns the same
    switch (the same dict) as the loop, over random configs and related
    pairs, a flanked config, a bucketed poison-padded pair and the default
    config on a planted pair;
  * the whole record (cost, alignment, TOML text but its wall times) equals
    the one traced with the loop;
  * every finite cell of every round's reentry field, off the traced path
    too, where several candidates often explain one value: the same switch;
  * the tabulated costs equal ``_eval`` at every integer of their ranges,
    INF edges included, and ``_ExitModule.price_many`` equals
    ``_ExitModule.price`` at every (l, b) of a kind, windows cut short at
    RN's end included.
"""

import numpy as np
import pytest

import tsalign_tpu_torch
from tsalign_tpu.alphabet import get_alphabet
from tsalign_tpu_torch import geometry as port_geometry
from tsalign_tpu_torch import traceback as tb
from tsalign_tpu_torch.convert import config_from_reference
from tsalign_tpu_torch.costs import INF
from tsalign_tpu_torch.engine import TorchAligner
from tsalign_tpu_torch.fields import entry_cells_of

from torch_util import one_torch_thread  # noqa: F401
from util import random_config, related_pair


def _loop_reconstruct(self, i, j, v, A_cells):
    """The candidate loop as it was: kinds x l x ldiff, one `price` each."""
    cfg = self.config
    length_fn, ldiff_fn = cfg.length_costs, cfg.length_difference_costs
    dw = ldiff_fn.finite_window()
    if dw is None:
        raise RuntimeError("traceback: reentry with no finite ldiff")
    span = 2 * max(self.n_r, self.n_q) + 2
    d_lo, d_hi = max(int(dw[0]), -span), min(int(dw[1]), span)
    for pk in self.allowed_primaries:
        A_mod = A_cells if pk == 0 else A_cells.T
        anti_lo, anti_hi = self.anti_bounds[pk]
        p2, j2 = (i, j) if pk == 0 else (j, i)
        for sk in (0, 1):
            for dk in (0, 1):
                spec = self._spec(pk, sk, dk)
                if spec is None:
                    continue
                if not (0 <= j2 < spec.n_anti_real):
                    continue
                anti_fn = cfg.anti_primary_gap_costs(tb._DK[dk])
                em = self._exit_module(pk, sk, dk, spec, p2)
                for l in range(spec.min_len, min(spec.l_max, p2) + 1):
                    lc = tb._eval(length_fn, l)
                    if lc >= INF:
                        continue
                    p1 = p2 - l
                    for ldiff in range(d_lo, d_hi + 1):
                        if ldiff > 0 and p2 + ldiff > anti_hi:
                            continue
                        if ldiff < 0 and p2 + ldiff < anti_lo:
                            continue
                        ag = l + ldiff
                        dc = tb._eval(ldiff_fn, ldiff)
                        ac = tb._eval(anti_fn, ag)
                        if dc >= INF or ac >= INF:
                            continue
                        e_anti = j2 - ag
                        if not (0 <= e_anti <= spec.n_anti):
                            continue
                        a = int(A_mod[p1, e_anti])
                        if a >= INF:
                            continue
                        rem = v - a - lc - dc - ac
                        slack = self.config.secondary_length_bonus * spec.l_max
                        if rem < -slack:
                            continue
                        b = p1 if spec.same_seq else e_anti
                        if em.price(l, b) != rem:
                            continue
                        col = self._column(pk, sk, dk, spec, p1, b)
                        if col.B[l] == rem:
                            fo, sec_ops = col.backtrack(l, rem)
                            return {"pk": pk, "sk": sk, "dk": dk, "p1": p1,
                                    "e_anti": e_anti, "l": l, "ag": ag, "fo": fo,
                                    "sec_ops": sec_ops, "entry_cost": a}
    raise RuntimeError(f"traceback: no TSM explains reentry at ({i},{j}) = {v}")


_search = tb.TracebackEngine._reconstruct_tsm


def _traced(monkeypatch, run):
    """(what `run` returns with the loop, with the array search, and the
    (search, loop) answers of every reentry the search explained)."""
    monkeypatch.setattr(tb.TracebackEngine, "_reconstruct_tsm", _loop_reconstruct)
    want = run()
    seen = []

    def both(self, i, j, v, A_cells):
        got = _search(self, i, j, v, A_cells)
        seen.append((got, _loop_reconstruct(self, i, j, v, A_cells)))
        return got

    monkeypatch.setattr(tb.TracebackEngine, "_reconstruct_tsm", both)
    return want, run(), seen


def _record(res):
    return "\n".join(line for line in res.to_toml().splitlines()
                     if not line.startswith(("duration_seconds", "runtime")))


def _facade_case(seed, flanks):
    al = get_alphabet("dna")
    rng = np.random.default_rng(seed)
    cfg = random_config(rng, al, flanks=flanks)
    r, q = related_pair(rng, al, max_len=16)
    return config_from_reference(cfg), al.decode(r), al.decode(q)


def _planted(n, seed, stretch):
    rng = np.random.default_rng(seed)
    r = "".join(rng.choice(list("ACGT"), n))
    a = n // 4
    q = r[:a] + r[a:a + stretch][::-1].translate(str.maketrans("ACGT", "TGCA")) + r[a + stretch:]
    return r, q


FACADE_CASES = {
    **{f"random-{s}": (s, False) for s in (2, 15, 16, 17, 28)},
    **{f"flanked-{s}": (s, True) for s in (17, 31, 32)},
}


@pytest.mark.parametrize("case", [*FACADE_CASES, "default-planted"])
def test_array_search_equals_the_loop(monkeypatch, case):
    if case == "default-planted":
        r, q = _planted(40, 1, 10)
        aligner = tsalign_tpu_torch.Aligner(device="cpu")
    else:
        cfg, r, q = _facade_case(*FACADE_CASES[case])
        aligner = tsalign_tpu_torch.Aligner(costs=cfg, device="cpu")
    want, got, seen = _traced(monkeypatch, lambda: aligner.align(r, q))
    assert seen, "no template switch was traced"
    for new, old in seen:
        assert new == old
    assert got.result.cost == want.result.cost
    assert got.result.alignment == want.result.alignment
    assert _record(got) == _record(want)


def test_array_search_equals_the_loop_on_a_padded_pair(monkeypatch):
    """A bucketed problem: the pair poison-padded to 24 x 24, its real
    lengths given by the range, the reentry bound by the real anti length."""
    al = get_alphabet("dna")
    rng = np.random.default_rng(61)
    cfg = config_from_reference(random_config(rng, al))
    while True:
        r, q = related_pair(rng, al, max_len=16)
        pad = lambda s: np.concatenate([s, np.full(24 - len(s), al.size, dtype=s.dtype)])
        eng = TorchAligner(cfg, pad(r), pad(q), device="cpu",
                           range_=port_geometry.AlignmentRange(0, 0, len(r), len(q)))
        want, got, seen = _traced(monkeypatch, eng.align_with_traceback)
        if seen:
            break
    for new, old in seen:
        assert new == old
    assert got[0] == want[0] < INF and got[1] == want[1]


@pytest.mark.parametrize("seed,flanks", [(0, False), (3, False), (4, False),
                                         (1, True), (4, True), (5, True)])
def test_array_search_equals_the_loop_at_every_reentry_cell(seed, flanks):
    """Not only the traced path's reentries: every finite cell of every
    round's reentry field, where several (l, ldiff) often explain one value
    and the first in the loop's order has to win."""
    al = get_alphabet("dna")
    rng = np.random.default_rng(seed)
    cfg = config_from_reference(random_config(rng, al, flanks=flanks))
    r, q = related_pair(rng, al, max_len=12)
    res = TorchAligner(cfg, r, q, device="cpu", keep_fields=True).align()
    new, old = tb.TracebackEngine(cfg, r, q), tb.TracebackEngine(cfg, r, q)
    cells = 0
    for k, R in enumerate(res.reentry_fields):
        A = entry_cells_of(res.primary_fields[k])
        for i, j in zip(*np.nonzero(np.asarray(R) < INF)):
            args = (int(i), int(j), int(R[i, j]), A)
            assert new._reconstruct_tsm(*args) == _loop_reconstruct(old, *args)
            cells += 1
    assert cells >= 50


def _functions(cfg):
    return {"length": cfg.length_costs, "ldiff": cfg.length_difference_costs,
            "anti_forward": cfg.anti_primary_gap_costs("Forward"),
            "anti_reverse": cfg.anti_primary_gap_costs("Reverse")}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cost_tables_equal_eval(seed):
    """`_cost_table` at every integer from below the first point's input to
    past the finite window, and the engine's tables over the ranges its
    grids read, equal `_eval` there."""
    al = get_alphabet("dna")
    rng = np.random.default_rng(seed)
    cfg = config_from_reference(random_config(rng, al))
    for fn in _functions(cfg).values():
        lo, hi = fn.finite_window()
        first = max(fn.points[0][0], -(2**40))
        for a, b in ((lo - 12, hi + 12), (first - 3, first + 3)):
            xs = range(a, b + 1)
            assert tb._cost_table(fn, a, b).tolist() == [tb._eval(fn, x) for x in xs]
        assert INF in tb._cost_table(fn, lo - 12, hi + 12)
    r, q = related_pair(rng, al, max_len=16)
    eng = tb.TracebackEngine(cfg, r, q)
    n = max(len(r), len(q))
    min_len, (d_lo, d_hi) = 2, (-7, 5)
    lc, dc, ac = eng._cost_tables(min_len, d_lo, d_hi)
    assert lc.tolist() == [tb._eval(cfg.length_costs, x) for x in range(min_len, n + 1)]
    assert dc.tolist() == [tb._eval(cfg.length_difference_costs, x) for x in range(d_lo, d_hi + 1)]
    for dk, name in enumerate(("Forward", "Reverse")):
        fn = cfg.anti_primary_gap_costs(name)
        assert ac[dk].tolist() == [tb._eval(fn, x) for x in range(min_len + d_lo, n + d_hi + 1)]
    assert eng._cost_tables(min_len, d_lo, d_hi) is eng._cost_tables(min_len, d_lo, d_hi)


@pytest.mark.parametrize("cut,bonus", [(0, 0), (3, 0), (0, 1)])
@pytest.mark.parametrize("kind", [(0, 0, 0), (0, 1, 1), (1, 0, 1), (1, 1, 0)])
def test_price_many_equals_price(kind, cut, bonus):
    """Every (l, b) of one kind at one exit, l past the DP's last level
    included; `cut` drops RN's last columns after the DP, so the widest b's
    windows run past its end and price INF in both; `bonus` 1 (the maximise
    tie-break's) makes RN negative, also beside INF seeds."""
    al = get_alphabet("dna")
    rng = np.random.default_rng(5)
    cfg = config_from_reference(random_config(rng, al))
    cfg.secondary_length_bonus = bonus
    for key in cfg.base_cost:
        cfg.base_cost[key] = 1
    r = rng.integers(0, 4, size=18).astype(np.int8)
    q = rng.integers(0, 4, size=15).astype(np.int8)
    eng = tb.TracebackEngine(cfg, r, q)
    spec = eng._spec(*kind)
    p2 = spec.n_p - 2
    em = eng._exit_module(*kind, spec, p2)
    if cut:
        em.RN = em.RN[:, :-cut]
    ls, bs = np.meshgrid(np.arange(em.L + 3), np.arange(spec.n_s + 1), indexing="ij")
    ls, bs = ls.ravel(), bs.ravel()
    want = [em.price(int(l), int(b)) for l, b in zip(ls, bs)]
    got = em.price_many(ls, bs)
    assert got.tolist() == want
    assert min(want) < INF and (INF in want)
    assert (em.RN < 0).any() == bool(bonus)
