"""Dense gap-affine sweep over flank-indexed primary layers (numpy, exact).

Computes M[f, g, i, j] = minimum cost to reach the reference state
Primary(i, j, gap_type=g, flank_index=f) (see oracle.py / context.rs:135-375),
given seed costs (root and TSM reentries) injected at arbitrary cells.

Layer axis f is indexed 0..F-1 for flank indices -R..L.  Gap axis g:
0 = None, 1 = Insertion, 2 = Deletion.

Transitions (context.rs:164-354):
  * flank 0 "stay" steps with the primary table,
  * climb steps f -> f+1: right-flank table for f < 0 (always allowed),
    left-flank table for 0 <= f < L (gated on can_start_another_ts),
  * gap open vs extend decided by the source gap type,
  * sources gated to the primary range (NoPrune => full sequences).

The row recurrence is expressed with vector operations only:
  * deletions and diagonals come from the previous row (elementwise),
  * the insertion chain along a row is a (min,+) linear recurrence solved
    exactly with the prefix-sum trick:  D[j] = min(C[j], D[j-1] + e[j])
    ==>  D = S + cummin(C - S)  with S[j] = prefix sums of e.
This is the exact structure the TPU kernel uses (one row per grid step,
lanes across j).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import TemplateSwitchConfig
from ..costs import INF
from ..geometry import AlignmentRange

GAP_NONE, GAP_INS, GAP_DEL = 0, 1, 2

# Any accumulated value >= CLAMP is treated as infinity; per-step costs are
# capped at CLAMP so prefix sums cannot overflow int64.
CLAMP = 1 << 40


def _cap(x):
    return np.minimum(x, CLAMP)


def _clamp_inf(x):
    return np.where(x >= CLAMP, INF, x)


def sat_add(a, b):
    """Elementwise saturating a + b with INF absorption."""
    return _clamp_inf(_cap(a) + _cap(b))


def min_plus_scan(candidates: np.ndarray, extend: np.ndarray, axis: int = 0) -> np.ndarray:
    """Solve D[t] = min(C[t], D[t-1] + e[t]) along `axis`, exactly."""
    e = _cap(extend)
    s = np.cumsum(e, axis=axis)
    c = _cap(candidates)
    d = np.minimum.accumulate(c - s, axis=axis) + s
    return _clamp_inf(np.minimum(d, c))


class PrimarySweep:
    def __init__(
        self,
        config: TemplateSwitchConfig,
        reference: np.ndarray,
        query: np.ndarray,
        range_: Optional[AlignmentRange] = None,
        allow_flank_climb: bool = True,
    ):
        self.config = config
        self.ref = np.asarray(reference, dtype=np.int64)
        self.qry = np.asarray(query, dtype=np.int64)
        self.n_r = len(self.ref)
        self.n_q = len(self.qry)
        self.range = range_ or AlignmentRange.complete(self.n_r, self.n_q)
        self.L = config.left_flank_length
        self.R = config.right_flank_length
        # can_start_another_template_switch gates climbing the left flank
        # (context.rs:225-227,281-284,328-331); false under --no-ts.
        self.climb_enabled = allow_flank_climb
        self.F = self.L + self.R + 1

        self._tables = {}
        # Poison padding char support (bucketed batch/chain problems):
        # sequences may carry index == alphabet size; pad every table with
        # an INF row/column so any op touching padding is infeasible.
        from .primary import pad_table_for_poison as _pad_table_for_poison

        pad_idx = config.alphabet.size
        self.ref = np.clip(self.ref, 0, pad_idx)
        self.qry = np.clip(self.qry, 0, pad_idx)
        for name, table in (
            ("primary", config.primary_edit_costs),
            ("left", config.left_flank_edit_costs),
            ("right", config.right_flank_edit_costs),
        ):
            table = _pad_table_for_poison(table)
            if self.n_r and self.n_q:
                sub = table.substitution[self.ref[:, None], self.qry[None, :]]
            else:
                sub = np.zeros((self.n_r, self.n_q), dtype=np.int64)
            self._tables[name] = {
                "sub": sub,  # (n_r, n_q): cost of aligning ref[i] with qry[j]
                "del_open": table.gap_open[self.ref] if self.n_r else np.zeros(0, dtype=np.int64),
                "del_ext": table.gap_extend[self.ref] if self.n_r else np.zeros(0, dtype=np.int64),
                "ins_open": table.gap_open[self.qry] if self.n_q else np.zeros(0, dtype=np.int64),
                "ins_ext": table.gap_extend[self.qry] if self.n_q else np.zeros(0, dtype=np.int64),
            }

        # Source-cell range gating for consuming ref[i] / qry[j].
        self.ref_ok = np.zeros(self.n_r + 1, dtype=bool)
        self.qry_ok = np.zeros(self.n_q + 1, dtype=bool)
        self.ref_ok[self.range.reference_offset : self.range.reference_limit] = True
        self.qry_ok[self.range.query_offset : self.range.query_limit] = True

    def layer_index(self, flank: int) -> int:
        return flank + self.R

    # -- per-layer, per-row transition pieces ------------------------------

    def _diag_from(self, src_row, table, i):
        """min over gap types of src (prev row), consuming ref[i-1], qry[j-1]."""
        n_q = self.n_q
        out = np.full(n_q + 1, INF, dtype=np.int64)
        if i == 0 or not self.ref_ok[i - 1]:
            return out
        src_any = src_row.min(axis=0)  # (n_q+1,)
        sub = np.where(self.qry_ok[:n_q], table["sub"][i - 1], INF)
        out[1:] = _cap(src_any[:n_q]) + _cap(sub)
        return _clamp_inf(out)

    def _del_from(self, src_row, table, i):
        """Deletion from prev row same column, consuming ref[i-1]."""
        n_q = self.n_q
        if i == 0 or not self.ref_ok[i - 1]:
            return np.full(n_q + 1, INF, dtype=np.int64)
        open_src = np.minimum(src_row[GAP_NONE], src_row[GAP_INS])
        d = np.minimum(
            _cap(open_src) + _cap(table["del_open"][i - 1]),
            _cap(src_row[GAP_DEL]) + _cap(table["del_ext"][i - 1]),
        )
        return _clamp_inf(d)

    def _ins_from(self, src_row, table):
        """Insertion from same row (column j-1), consuming qry[j-1].

        Returns (open_candidates, extend_candidates): both as target-indexed
        vectors; extend_candidates is only used for cross-layer climbs (for
        within-layer chains use min_plus_scan instead).
        """
        n_q = self.n_q
        qmask = np.where(self.qry_ok[:n_q], 0, INF)
        open_out = np.full(n_q + 1, INF, dtype=np.int64)
        ext_out = np.full(n_q + 1, INF, dtype=np.int64)
        open_src = np.minimum(src_row[GAP_NONE], src_row[GAP_DEL])
        open_out[1:] = _cap(open_src[:n_q]) + _cap(table["ins_open"] + qmask)
        ext_out[1:] = _cap(src_row[GAP_INS][:n_q]) + _cap(table["ins_ext"] + qmask)
        return _clamp_inf(open_out), _clamp_inf(ext_out)

    # -- main sweep ---------------------------------------------------------

    def sweep(self, seeds: np.ndarray) -> np.ndarray:
        """seeds: (F, 3, n_r+1, n_q+1) int64 (INF = no seed).  Returns M."""
        F, n_r, n_q, L, R = self.F, self.n_r, self.n_q, self.L, self.R
        M = np.full((F, 3, n_r + 1, n_q + 1), INF, dtype=np.int64)

        t_primary = self._tables["primary"]
        t_left = self._tables["left"]
        t_right = self._tables["right"]
        qmask = np.where(self.qry_ok[:n_q], 0, INF)

        for i in range(n_r + 1):
            row = np.array(seeds[:, :, i, :], dtype=np.int64)
            prev = M[:, :, i - 1, :] if i > 0 else None

            # Layers bottom-up so climb sources are finalized first.
            for f in range(-R, L + 1):
                fi = self.layer_index(f)

                # climb source layer & its table (None if no climb into f)
                if (-R < f < 0) or (f == 0 and R > 0):
                    climb_src, climb_table = fi - 1, t_right
                elif f > 0 and self.climb_enabled:
                    climb_src, climb_table = fi - 1, t_left
                else:
                    climb_src, climb_table = None, None

                none_c = row[fi, GAP_NONE]
                del_c = row[fi, GAP_DEL]
                ins_c = row[fi, GAP_INS]

                if prev is not None:
                    if f == 0:
                        none_c = np.minimum(none_c, self._diag_from(prev[fi], t_primary, i))
                        del_c = np.minimum(del_c, self._del_from(prev[fi], t_primary, i))
                    if climb_src is not None:
                        none_c = np.minimum(
                            none_c, self._diag_from(prev[climb_src], climb_table, i)
                        )
                        del_c = np.minimum(
                            del_c, self._del_from(prev[climb_src], climb_table, i)
                        )

                row[fi, GAP_NONE] = none_c
                row[fi, GAP_DEL] = del_c

                if climb_src is not None:
                    o, e = self._ins_from(row[climb_src], climb_table)
                    ins_c = np.minimum(ins_c, np.minimum(o, e))

                if f == 0:
                    # within-layer insertion chain (primary table)
                    open_c = np.full(n_q + 1, INF, dtype=np.int64)
                    open_src = np.minimum(row[fi, GAP_NONE], row[fi, GAP_DEL])
                    open_c[1:] = _cap(open_src[:n_q]) + _cap(t_primary["ins_open"] + qmask)
                    cands = np.minimum(ins_c, _clamp_inf(open_c))
                    ext = np.zeros(n_q + 1, dtype=np.int64)
                    ext[1:] = t_primary["ins_ext"] + qmask
                    row[fi, GAP_INS] = min_plus_scan(cands, ext, axis=0)
                else:
                    row[fi, GAP_INS] = ins_c

            M[:, :, i, :] = row

        return M

    def root_seeds(self) -> np.ndarray:
        seeds = np.full((self.F, 3, self.n_r + 1, self.n_q + 1), INF, dtype=np.int64)
        seeds[
            self.layer_index(0),
            GAP_NONE,
            self.range.reference_offset,
            self.range.query_offset,
        ] = 0
        return seeds

    def target_cost(self, M: np.ndarray) -> int:
        return int(M[:, :, self.range.reference_limit, self.range.query_limit].min())
