"""Host-side traceback over the dense engine's fields.

Given the per-round primary fields M_k and reentry fields R_k produced by
DenseAligner / JaxAligner, reconstruct one optimal alignment:

  * walk the primary layers backward (reverse of ops/primary_sweep.py
    transitions), emitting Primary / PrimaryFlank ops;
  * when a cell's value is explained by a reentry seed, identify the
    template switch that produced it — enumerate (kind, l, ldiff)
    candidates against the previous round's entry field, confirm with a
    single-entry-cell module column DP, and reconstruct the secondary path;
  * emit the entrance-offset walk and exit anti-gap walk edge sequences
    exactly as the sparse reference search would (payload multiplicities
    |fo|(+1) and |ldiff|+1, final payload kept by the RLE merge —
    a_star_aligner.rs:104-122).

The result re-prices to the optimal cost (pricing.py) by construction.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from . import alignment as at
from .alignment import Alignment, EqualCostRange, TemplateSwitchEntrance, TemplateSwitchExit
from .config import TemplateSwitchConfig
from .costs import INF
from .geometry import AlignmentRange
from .ops.primary_sweep import GAP_DEL, GAP_INS, GAP_NONE
from .ops.tsm_modules import KindSpec, make_kind_spec

_PK = ("Reference", "Query")
_DK = ("Forward", "Reverse")


def _eval(fn, x: int) -> int:
    return fn.evaluate(x) if x >= fn.points[0][0] else INF


class _ModuleColumn:
    """Single-entry-cell module DP with stored per-level tables."""

    def __init__(self, spec: KindSpec, config, ref, qry, b: int, p1: int, allow_sdel: bool):
        self.spec = spec
        self._p1 = p1
        # Poison padding char (index == alphabet size, chained-mode bucketed
        # segments) complements to itself and prices as INF via the padded
        # table (ops.primary.pad_table_for_poison).
        from .ops.primary import pad_table_for_poison as _pad_table_for_poison

        A = config.alphabet.size
        comp = np.append(
            config.alphabet.complement_array().astype(np.int64), A
        )
        table = _pad_table_for_poison(config.secondary_edit_costs(_DK[spec.dk]))
        P = np.asarray(ref if spec.pk == 0 else qry, dtype=np.int64)
        sec = np.asarray(ref if spec.sk == 0 else qry, dtype=np.int64)
        n_s, r_lo, r_hi = spec.n_s, spec.r_lo, spec.r_hi
        W = r_hi - r_lo + 1
        self.W, self.r_lo = W, r_lo
        r = np.arange(r_lo, r_hi + 1)
        cidx = b + r if spec.dk == 0 else b + r - 1
        valid = (cidx >= 0) & (cidx < n_s)
        raw = sec[np.clip(cidx, 0, max(n_s - 1, 0))] if n_s else np.zeros_like(cidx)
        self.schar = np.where(valid, comp[raw] if spec.dk == 1 else raw, -1)
        self.sdel_open = np.where(valid, table.gap_open[self.schar.clip(0)], INF)
        self.sdel_ext = np.where(valid, table.gap_extend[self.schar.clip(0)], INF)
        bonus = config.secondary_length_bonus
        self.sub = np.where(table.substitution < INF, table.substitution - bonus, INF)
        self.pgo = np.where(table.gap_open < INF, table.gap_open - bonus, INF)
        self.pge = np.where(table.gap_extend < INF, table.gap_extend - bonus, INF)
        self.P = P
        self.b = b
        self.allow_sdel = allow_sdel
        self.delta = 1 if spec.dk == 0 else -1
        self._run()

    def _run(self):
        spec = self.spec
        L, W = spec.l_max, self.W
        T = np.full((L + 1, 3, W), INF, dtype=np.int64)
        T[0, GAP_NONE] = spec.seed[self.b]
        for lvl in range(L + 1):
            self._close(T[lvl])
            if lvl == L:
                break
            # transitions consume the primary char P[p1 + lvl]
            pidx = self._p1 + lvl
            if pidx < spec.n_p:
                pc = int(self.P[pidx])
                src_any = T[lvl].min(axis=0)
                sub = np.where(self.schar >= 0, self.sub[pc, self.schar.clip(0)], INF)
                diag = np.where((src_any < INF) & (sub < INF), src_any + sub, INF)
                if self.delta == 1:
                    T[lvl + 1, GAP_NONE, 1:] = diag[:-1]
                else:
                    T[lvl + 1, GAP_NONE, :-1] = diag[1:]
                io, ie = int(self.pgo[pc]), int(self.pge[pc])
                open_src = np.minimum(T[lvl, GAP_NONE], T[lvl, GAP_DEL])
                ins = np.minimum(
                    np.where(open_src < INF, open_src + io, INF),
                    np.where(T[lvl, GAP_INS] < INF, T[lvl, GAP_INS] + ie, INF),
                )
                T[lvl + 1, GAP_INS] = ins
        self.T = T
        self.B = T.min(axis=(1, 2))

    def _close(self, Tl):
        if not self.allow_sdel:
            return
        from .ops.primary_sweep import min_plus_scan, sat_add as _sat

        W = self.W
        open_src = np.minimum(Tl[GAP_NONE], Tl[GAP_INS])
        if self.delta == 1:
            cand = np.full(W, INF, dtype=np.int64)
            cand[1:] = _sat(open_src[:-1], self.sdel_open[:-1])
            cand = np.minimum(cand, Tl[GAP_DEL])
            ext = np.full(W, INF, dtype=np.int64)
            ext[1:] = self.sdel_ext[:-1]
            Tl[GAP_DEL] = min_plus_scan(cand, ext, axis=0)
        else:
            cand = np.full(W, INF, dtype=np.int64)
            cand[:-1] = _sat(open_src[1:], self.sdel_open[1:])
            cand = np.minimum(cand, Tl[GAP_DEL])
            ext = np.full(W, INF, dtype=np.int64)
            ext[:-1] = self.sdel_ext[1:]
            Tl[GAP_DEL] = min_plus_scan(cand[::-1], ext[::-1], axis=0)[::-1]

    def backtrack(self, level: int, value: int) -> Tuple[int, List[str]]:
        """Reconstruct the secondary op path ending at `level` with `value`.
        Returns (first_offset, ops forward order)."""
        spec = self.spec
        T = self.T
        # find an achieving (g, r)
        hit = np.argwhere(T[level] == value)
        if len(hit) == 0:
            raise RuntimeError("module backtrack: value not found")
        g, r = (int(hit[0][0]), int(hit[0][1]))
        ops: List[str] = []
        lvl = level
        v = value
        while True:
            if g == GAP_NONE and lvl == 0 and spec.seed[self.b][r] == v:
                return self.r_lo + r, list(reversed(ops))
            if g == GAP_DEL:
                src = r - self.delta
                if 0 <= src < self.W:
                    so, se = self.sdel_open[src], self.sdel_ext[src]
                    for g2 in (GAP_NONE, GAP_INS):
                        if so < INF and T[lvl, g2, src] < INF and T[lvl, g2, src] + so == v:
                            ops.append(at.SECONDARY_DELETION)
                            g, r, v = g2, src, int(T[lvl, g2, src])
                            break
                    else:
                        if se < INF and T[lvl, GAP_DEL, src] < INF and T[lvl, GAP_DEL, src] + se == v:
                            ops.append(at.SECONDARY_DELETION)
                            r, v = src, int(T[lvl, GAP_DEL, src])
                        else:
                            raise RuntimeError("module backtrack: deletion stuck")
                    continue
                raise RuntimeError("module backtrack: deletion at window edge")
            pidx = self._p1 + lvl - 1
            pc = int(self.P[pidx]) if 0 <= pidx < len(self.P) else None
            if g == GAP_NONE:
                src = r - self.delta
                if pc is None or not (0 <= src < self.W) or lvl == 0:
                    raise RuntimeError("module backtrack: match stuck")
                sc = int(self.schar[src])
                cost = int(self.sub[pc, sc]) if sc >= 0 else INF
                found = False
                for g2 in (GAP_NONE, GAP_INS, GAP_DEL):
                    pv = T[lvl - 1, g2, src]
                    if cost < INF and pv < INF and pv + cost == v:
                        ops.append(
                            at.SECONDARY_MATCH if pc == sc else at.SECONDARY_SUBSTITUTION
                        )
                        g, r, v, lvl = g2, src, int(pv), lvl - 1
                        found = True
                        break
                if not found:
                    raise RuntimeError("module backtrack: match stuck")
                continue
            # GAP_INS
            if pc is None or lvl == 0:
                raise RuntimeError("module backtrack: insertion stuck")
            io, ie = int(self.pgo[pc]), int(self.pge[pc])
            found = False
            for g2, c in ((GAP_NONE, io), (GAP_DEL, io), (GAP_INS, ie)):
                pv = T[lvl - 1, g2, r]
                if pv < INF and pv + c == v:
                    ops.append(at.SECONDARY_INSERTION)
                    g, v, lvl = g2, int(pv), lvl - 1
                    found = True
                    break
            if not found:
                raise RuntimeError("module backtrack: insertion stuck")


class _ExitModule:
    """Exit-anchored pricing of ALL candidate module columns of one kind.

    Every candidate of one `_reconstruct_tsm` call shares the exit primary
    position p2 (a forward column consumes P[p1..p2) with p1 = p2 - l), so
    ONE backward (min,+)-adjoint DP over the ABSOLUTE secondary axis
    prices B[l] of every (l, b) with a single vector min:

        B(l, b) = min_a  seed[b][a - base(b)] + RN[l][a]

    where RN[l] = close_adj(R[l])[GAP_NONE] and R[m] = value-to-go of
    consuming the last m primary chars to the closed exit (the adjoint of
    `_ModuleColumn._run`'s close/transition chain; `close_adj` absorbs the
    level-0 seed closure via <close(seed), R> = <seed, close_adj(R)>).
    The forward column — the executable spec, equality-tested in
    tests/test_traceback.py — is built only for the one matching
    candidate (its level tables drive the backtrack).  This removed the
    round-5 record-wall hotspot: 2805 full column DPs per reconstruct
    (58 s of a 71.5 s warm record, scripts/profile_record.py).
    """

    def __init__(self, spec: KindSpec, config, ref, qry, p2: int,
                 allow_sdel: bool):
        self.spec = spec
        comp = np.append(
            config.alphabet.complement_array().astype(np.int64),
            config.alphabet.size,
        )
        from .ops.primary import pad_table_for_poison as _pad_table_for_poison

        table = _pad_table_for_poison(config.secondary_edit_costs(_DK[spec.dk]))
        P = np.asarray(ref if spec.pk == 0 else qry, dtype=np.int64)
        sec = np.asarray(ref if spec.sk == 0 else qry, dtype=np.int64)
        n_s, r_lo, r_hi = spec.n_s, spec.r_lo, spec.r_hi
        self.W = W = r_hi - r_lo + 1
        self.delta = 1 if spec.dk == 0 else -1
        self.base_off = r_lo - (1 if spec.dk == 1 else 0)
        # absolute secondary axis: a = b + r (+ dk shift), b over the seed
        # table's first axis [0, n_s]
        n_b = spec.n_s
        self.a_lo = a_lo = self.base_off
        a_hi = n_b + self.base_off + W - 1
        WA = a_hi - a_lo + 1
        a = np.arange(a_lo, a_hi + 1)
        valid = (a >= 0) & (a < n_s)
        raw = sec[np.clip(a, 0, max(n_s - 1, 0))] if n_s else np.zeros_like(a)
        schar = np.where(valid, comp[raw] if spec.dk == 1 else raw, -1)
        bonus = config.secondary_length_bonus
        sub = np.where(table.substitution < INF, table.substitution - bonus, INF)
        self.pgo = np.where(table.gap_open < INF, table.gap_open - bonus, INF)
        self.pge = np.where(table.gap_extend < INF, table.gap_extend - bonus, INF)
        sdel_open = np.where(valid, table.gap_open[schar.clip(0)], INF)
        sdel_ext = np.where(valid, table.gap_extend[schar.clip(0)], INF)

        d = self.delta

        def shift_from(x, k):
            """y[a] = x[a + k] (INF beyond the window)."""
            y = np.full_like(x, INF)
            if k >= 0:
                if k < len(x):
                    y[: len(x) - k] = x[k:]
            else:
                y[-k:] = x[:k] if k != 0 else x
            return y

        def close_adj(R):
            """Adjoint of _ModuleColumn._close: value-to-go BEFORE the
            within-level sdel closure, given value-to-go after (R)."""
            if not allow_sdel:
                return R
            Rn, Ri, Rd = R
            # X[a] = min(Rd[a], sdel_ext[a] + X[a + d]) — the DEL chain's
            # directional value-to-go (a min-plus scan, reversed for d=1).
            X = _chain_to_go(Rd, sdel_ext, d)
            open_to = shift_from(X, d)
            U_n = np.minimum(Rn, _sat(sdel_open, open_to))
            U_i = np.minimum(Ri, _sat(sdel_open, open_to))
            return U_n, U_i, X

        L = min(spec.l_max, p2)
        self.L = L
        RN = np.full((L + 1, WA), INF, dtype=np.int64)
        R = (
            np.zeros(WA, dtype=np.int64),
            np.zeros(WA, dtype=np.int64),
            np.zeros(WA, dtype=np.int64),
        )
        U = close_adj(R)
        RN[0] = U[0]  # seed populates GAP_NONE only
        for m in range(1, L + 1):
            pidx = p2 - m
            if pidx < 0 or pidx >= spec.n_p:
                break
            pc = int(P[pidx])
            sub_a = np.where(schar >= 0, sub[pc, schar.clip(0)], INF)
            io, ie = int(self.pgo[pc]), int(self.pge[pc])
            Un, Ui, Ud = U if m == 1 else close_adj(R)
            # diag: (any g, a) --sub_a[a]--> (NONE, a + d)
            diagc = _sat(sub_a, shift_from(Un, d))
            insN = _sat(np.full_like(Un, io), Ui)
            insI = _sat(np.full_like(Un, ie), Ui)
            R = (
                np.minimum(diagc, insN),
                np.minimum(diagc, insI),
                np.minimum(diagc, insN),
            )
            U = close_adj(R)
            RN[m] = U[0]
        self.RN = RN

    def price(self, l: int, b: int) -> int:
        """B[l] of the forward column (p1 = p2 - l, b), in O(W)."""
        if l > self.L:
            return int(INF)
        base = b + self.base_off - self.a_lo
        window = self.RN[l][base : base + self.W]
        seed = self.spec.seed[b]
        if window.shape[0] != self.W:
            return int(INF)
        v = _sat(seed, window).min()
        return int(v)


def _chain_to_go(Rd: np.ndarray, ext: np.ndarray, d: int) -> np.ndarray:
    """X[a] = min(Rd[a], ext[a] + X[a + d]) — directional value-to-go of
    the sdel DEL chain, via the forward min-plus scan on the (possibly
    reversed) axis: min_plus_scan computes D[t] = min(c[t], D[t-1]+e[t])."""
    from .ops.primary_sweep import min_plus_scan

    if d == 1:
        return min_plus_scan(Rd[::-1], ext[::-1], axis=0)[::-1]
    return min_plus_scan(Rd, ext, axis=0)


def _sat(a, b):
    """Saturating (min,+) add on host int64 (INF-absorbing)."""
    a = np.asarray(a)
    b = np.asarray(b)
    return np.where((a < INF) & (b < INF), a + b, INF)


class TracebackEngine:
    def __init__(
        self,
        config: TemplateSwitchConfig,
        reference: np.ndarray,
        query: np.ndarray,
        range_: Optional[AlignmentRange] = None,
        prune_range: bool = False,
        allow_secondary_deletions: bool = True,
        sdel_budget: Optional[int] = None,
        allow_flank_climb_last: bool = True,
        allowed_primaries=(0, 1),
    ):
        self.config = config
        self.ref = np.asarray(reference, dtype=np.int64)
        self.qry = np.asarray(query, dtype=np.int64)
        n_r, n_q = len(self.ref), len(self.qry)
        self.n_r, self.n_q = n_r, n_q
        self.range = range_ or AlignmentRange.complete(n_r, n_q)
        self.allow_sdel = allow_secondary_deletions
        self.sdel_budget = sdel_budget
        self.allowed_primaries = tuple(allowed_primaries)
        # Real content lengths: padded (poison) inputs must not widen the
        # structural feasibilities (see tsm_modules.KindSpec).
        from .ops.tsm_modules import real_seq_length

        self.n_r_real = real_seq_length(self.ref, config.alphabet.size)
        self.n_q_real = real_seq_length(self.qry, config.alphabet.size)
        self._bucketed = self.n_r_real != n_r or self.n_q_real != n_q
        if prune_range:
            sweep = self.range
            self.anti_bounds = {
                0: (self.range.query_offset, self.range.query_limit),
                1: (self.range.reference_offset, self.range.reference_limit),
            }
        else:
            sweep = AlignmentRange.complete(n_r, n_q)
            self.anti_bounds = {0: (0, self.n_q_real), 1: (0, self.n_r_real)}
        self.ref_ok = np.zeros(n_r + 1, dtype=bool)
        self.qry_ok = np.zeros(n_q + 1, dtype=bool)
        self.ref_ok[sweep.reference_offset : sweep.reference_limit] = True
        self.qry_ok[sweep.query_offset : sweep.query_limit] = True
        self.L = config.left_flank_length
        self.R = config.right_flank_length
        self.F = self.L + self.R + 1
        self._specs: Dict[Tuple[int, int, int], Optional[KindSpec]] = {}
        self._columns: Dict[Tuple[int, int, int, int, int], _ModuleColumn] = {}

    # -- primary transitions (reverse) -------------------------------------

    def _tables_into_layer(self, f: int, climb: bool):
        """[(source layer index, table, is_flank_edge)] for edges into layer f."""
        cfg = self.config
        out = []
        fi = f + self.R
        if f == 0:
            out.append((fi, cfg.primary_edit_costs, False))
        if (-self.R < f < 0) or (f == 0 and self.R > 0):
            out.append((fi - 1, cfg.right_flank_edit_costs, True))
        elif f > 0 and climb:
            out.append((fi - 1, cfg.left_flank_edit_costs, True))
        return out

    def _find_primary_pred(self, M, fi, g, i, j, v, climb: bool):
        """Returns (edge, (fi', g', i', j')) or None."""
        f = fi - self.R
        cands = self._tables_into_layer(f, climb)
        if g == GAP_NONE:
            if i >= 1 and j >= 1 and self.ref_ok[i - 1] and self.qry_ok[j - 1]:
                rc, qc = int(self.ref[i - 1]), int(self.qry[j - 1])
                for src_fi, table, flank in cands:
                    c = int(table.substitution[rc, qc])
                    if c >= INF:
                        continue
                    for g2 in (GAP_NONE, GAP_INS, GAP_DEL):
                        if M[src_fi, g2, i - 1, j - 1] + c == v and M[src_fi, g2, i - 1, j - 1] < INF:
                            if flank:
                                edge = (
                                    at.PRIMARY_FLANK_MATCH
                                    if rc == qc
                                    else at.PRIMARY_FLANK_SUBSTITUTION
                                )
                            else:
                                edge = at.PRIMARY_MATCH if rc == qc else at.PRIMARY_SUBSTITUTION
                            return edge, (src_fi, g2, i - 1, j - 1)
            return None
        if g == GAP_DEL:
            if i >= 1 and self.ref_ok[i - 1]:
                rc = int(self.ref[i - 1])
                for src_fi, table, flank in cands:
                    o, e = int(table.gap_open[rc]), int(table.gap_extend[rc])
                    edge = at.PRIMARY_FLANK_DELETION if flank else at.PRIMARY_DELETION
                    for g2, c in ((GAP_NONE, o), (GAP_INS, o), (GAP_DEL, e)):
                        pv = M[src_fi, g2, i - 1, j]
                        if c < INF and pv < INF and pv + c == v:
                            return edge, (src_fi, g2, i - 1, j)
            return None
        # GAP_INS
        if j >= 1 and self.qry_ok[j - 1]:
            qc = int(self.qry[j - 1])
            for src_fi, table, flank in cands:
                o, e = int(table.gap_open[qc]), int(table.gap_extend[qc])
                edge = at.PRIMARY_FLANK_INSERTION if flank else at.PRIMARY_INSERTION
                for g2, c in ((GAP_NONE, o), (GAP_DEL, o), (GAP_INS, e)):
                    pv = M[src_fi, g2, i, j - 1]
                    if c < INF and pv < INF and pv + c == v:
                        return edge, (src_fi, g2, i, j - 1)
        return None

    # -- TSM reconstruction -------------------------------------------------

    def _spec(self, pk, sk, dk) -> Optional[KindSpec]:
        key = (pk, sk, dk)
        if key not in self._specs:
            self._specs[key] = make_kind_spec(
                self.config, self.n_r, self.n_q, pk, sk, dk,
                sdel_budget=self.sdel_budget,
                n_ref_real=self.n_r_real if self._bucketed else None,
                n_qry_real=self.n_q_real if self._bucketed else None,
            )
        return self._specs[key]

    def _column(self, pk, sk, dk, spec, p1, b) -> _ModuleColumn:
        key = (pk, sk, dk, p1, b)
        if key not in self._columns:
            self._columns[key] = _ModuleColumn(
                spec, self.config, self.ref, self.qry, b, p1, self.allow_sdel
            )
        return self._columns[key]

    def _exit_module(self, pk, sk, dk, spec, p2) -> _ExitModule:
        key = (pk, sk, dk, p2)
        if not hasattr(self, "_exit_modules"):
            self._exit_modules = {}
        if key not in self._exit_modules:
            self._exit_modules[key] = _ExitModule(
                spec, self.config, self.ref, self.qry, p2, self.allow_sdel
            )
        return self._exit_modules[key]

    def _reconstruct_tsm(self, i, j, v, A_cells):
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
                    # strict reentry bound: the anti coordinate lands inside
                    # the REAL anti sequence
                    # (template_switch_distance.rs:600-618)
                    if not (0 <= j2 < spec.n_anti_real):
                        continue
                    anti_fn = cfg.anti_primary_gap_costs(_DK[dk])
                    em = self._exit_module(pk, sk, dk, spec, p2)
                    for l in range(spec.min_len, min(spec.l_max, p2) + 1):
                        lc = _eval(length_fn, l)
                        if lc >= INF:
                            continue
                        p1 = p2 - l
                        for ldiff in range(d_lo, d_hi + 1):
                            if ldiff > 0 and p2 + ldiff > anti_hi:
                                continue
                            if ldiff < 0 and p2 + ldiff < anti_lo:
                                continue
                            ag = l + ldiff
                            dc = _eval(ldiff_fn, ldiff)
                            ac = _eval(anti_fn, ag)
                            if dc >= INF or ac >= INF:
                                continue
                            e_anti = j2 - ag
                            if not (0 <= e_anti <= spec.n_anti):
                                continue
                            a = int(A_mod[p1, e_anti])
                            if a >= INF:
                                continue
                            rem = v - a - lc - dc - ac
                            # The secondary length bonus can push module
                            # costs below zero by at most l per module.
                            slack = self.config.secondary_length_bonus * spec.l_max
                            if rem < -slack:
                                continue
                            b = p1 if spec.same_seq else e_anti
                            # Exact O(W) candidate price from the shared
                            # exit-anchored DP; the full forward column is
                            # built only for the hit (its level tables
                            # drive the backtrack).
                            if em.price(l, b) != rem:
                                continue
                            col = self._column(pk, sk, dk, spec, p1, b)
                            if col.B[l] == rem:
                                fo, sec_ops = col.backtrack(l, rem)
                                return {
                                    "pk": pk,
                                    "sk": sk,
                                    "dk": dk,
                                    "p1": p1,
                                    "e_anti": e_anti,
                                    "l": l,
                                    "ag": ag,
                                    "fo": fo,
                                    "sec_ops": sec_ops,
                                    "entry_cost": a,
                                }
        raise RuntimeError(f"traceback: no TSM explains reentry at ({i},{j}) = {v}")

    def _tsm_edges(self, tsm) -> List[object]:
        """Forward edge list for one TSM (internal ops omitted)."""
        pk, sk, dk = tsm["pk"], tsm["sk"], tsm["dk"]
        fo, l, ag = tsm["fo"], tsm["l"], tsm["ag"]
        edges: List[object] = []

        def ent(x):
            return TemplateSwitchEntrance(
                first_offset=x,
                equal_cost_range=EqualCostRange.new_invalid(),
                primary=_PK[pk],
                secondary=_PK[sk],
                direction=_DK[dk],
            )

        if dk == 1:
            seq = [0]
            step = 1 if fo > 0 else -1
            x = 0
            while x != fo:
                x += step
                seq.append(x)
        else:
            step = 1 if fo > 0 else -1
            seq = [step]
            x = step
            while x != fo:
                x += step
                seq.append(x)
        edges.extend(ent(x) for x in seq)
        edges.extend(tsm["sec_ops"])
        ldiff = ag - l
        xs = [l]
        step = 1 if ldiff > 0 else -1
        x = l
        while x != ag:
            x += step
            xs.append(x)
        edges.extend(TemplateSwitchExit(anti_primary_gap=x) for x in xs)
        return edges

    # -- main ---------------------------------------------------------------

    def trace(
        self,
        primary_fields: List[np.ndarray],
        reentry_fields: List[np.ndarray],
        climb_flags: Optional[List[bool]] = None,
    ) -> Tuple[int, Alignment]:
        rng = self.range
        tl = (rng.reference_limit, rng.query_limit)
        best = INF
        k_star = 0
        for k, M in enumerate(primary_fields):
            c = int(M[:, :, tl[0], tl[1]].min())
            if c < best:
                best, k_star = c, k
        if best >= INF:
            return INF, Alignment([])
        if climb_flags is None:
            climb_flags = [True] * len(primary_fields)

        k = k_star
        M = primary_fields[k]
        sub = M[:, :, tl[0], tl[1]]
        fi, g = map(int, np.argwhere(sub == best)[0])
        i, j = tl
        v = best
        edges_rev: List[object] = []
        root_pos = (rng.reference_offset, rng.query_offset)
        guard = 0
        while True:
            guard += 1
            if guard > 4 * (self.n_r + self.n_q + 4) * (len(primary_fields) + 1):
                raise RuntimeError("traceback: guard tripped")
            if (
                fi == self.R
                and g == GAP_NONE
                and (i, j) == root_pos
                and v == 0
            ):
                break
            step = self._find_primary_pred(M, fi, g, i, j, v, climb_flags[k])
            if step is not None:
                edge, (fi, g, i, j) = step
                edges_rev.append(edge)
                v = int(M[fi, g, i, j])
                continue
            # must be a reentry seed
            if not (fi == 0 and g == GAP_NONE and k >= 1):
                raise RuntimeError(
                    f"traceback stuck at round {k} state ({fi},{g},{i},{j})={v}"
                )
            if int(reentry_fields[k - 1][i, j]) != v:
                raise RuntimeError(
                    f"traceback: seed mismatch at ({i},{j}): {v} vs "
                    f"{int(reentry_fields[k - 1][i, j])}"
                )
            from .fields import entry_cells_of

            A_cells = entry_cells_of(primary_fields[k - 1])
            tsm = self._reconstruct_tsm(i, j, v, A_cells)
            for e in reversed(self._tsm_edges(tsm)):
                edges_rev.append(e)
            k -= 1
            M = primary_fields[k]
            p1, e_anti = tsm["p1"], tsm["e_anti"]
            i, j = (p1, e_anti) if tsm["pk"] == 0 else (e_anti, p1)
            fi = self.F - 1
            a = tsm["entry_cost"]
            for g2 in (GAP_NONE, GAP_INS, GAP_DEL):
                if int(M[fi, g2, i, j]) == a:
                    g = g2
                    break
            else:
                raise RuntimeError("traceback: entry gap not found")
            v = a
        return best, Alignment.from_edge_sequence(reversed(edges_rev))
