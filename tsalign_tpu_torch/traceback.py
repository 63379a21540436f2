"""JAX-free traceback over the port's fields.

A thin subclass of ``tsalign_tpu.traceback.TracebackEngine``.  Three bodies
of the shared engine reach JAX at run time: ``_ModuleColumn.__init__`` and
``_ExitModule.__init__`` import the poison-table helper from
``ops/jax_primary.py``, and ``TracebackEngine.trace`` takes the entry layer
from ``device_fields``.  Those three bodies are copied here with the port's
helper (``ops.primary.pad_table_for_poison``) and field views
(``fields.FieldView4.entry_cells``); every other method is inherited
unchanged.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from tsalign_tpu import traceback as _tb
from tsalign_tpu.alignment import Alignment
from tsalign_tpu.costs import INF
from tsalign_tpu.ops.primary_sweep import GAP_DEL, GAP_INS, GAP_NONE
from tsalign_tpu.ops.tsm_modules import KindSpec

from .ops.primary import pad_table_for_poison

_DK = ("Forward", "Reverse")


class ModuleColumn(_tb._ModuleColumn):
    """``_ModuleColumn`` built with the port's poison-table helper."""

    def __init__(self, spec: KindSpec, config, ref, qry, b: int, p1: int, allow_sdel: bool):
        self.spec = spec
        self._p1 = p1
        A = config.alphabet.size
        comp = np.append(config.alphabet.complement_array().astype(np.int64), A)
        table = pad_table_for_poison(config.secondary_edit_costs(_DK[spec.dk]))
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


class ExitModule(_tb._ExitModule):
    """``_ExitModule`` built with the port's poison-table helper."""

    def __init__(self, spec: KindSpec, config, ref, qry, p2: int, allow_sdel: bool):
        _sat, _chain_to_go = _tb._sat, _tb._chain_to_go
        self.spec = spec
        comp = np.append(
            config.alphabet.complement_array().astype(np.int64), config.alphabet.size
        )
        table = pad_table_for_poison(config.secondary_edit_costs(_DK[spec.dk]))
        P = np.asarray(ref if spec.pk == 0 else qry, dtype=np.int64)
        sec = np.asarray(ref if spec.sk == 0 else qry, dtype=np.int64)
        n_s, r_lo, r_hi = spec.n_s, spec.r_lo, spec.r_hi
        self.W = W = r_hi - r_lo + 1
        self.delta = 1 if spec.dk == 0 else -1
        self.base_off = r_lo - (1 if spec.dk == 1 else 0)
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
            """Value-to-go before the within-level sdel closure."""
            if not allow_sdel:
                return R
            Rn, Ri, Rd = R
            X = _chain_to_go(Rd, sdel_ext, d)
            open_to = shift_from(X, d)
            U_n = np.minimum(Rn, _sat(sdel_open, open_to))
            U_i = np.minimum(Ri, _sat(sdel_open, open_to))
            return U_n, U_i, X

        L = min(spec.l_max, p2)
        self.L = L
        RN = np.full((L + 1, WA), INF, dtype=np.int64)
        R = (np.zeros(WA, dtype=np.int64),) * 3
        U = close_adj(R)
        RN[0] = U[0]
        for m in range(1, L + 1):
            pidx = p2 - m
            if pidx < 0 or pidx >= spec.n_p:
                break
            pc = int(P[pidx])
            sub_a = np.where(schar >= 0, sub[pc, schar.clip(0)], INF)
            io, ie = int(self.pgo[pc]), int(self.pge[pc])
            Un, Ui, Ud = U if m == 1 else close_adj(R)
            diagc = _sat(sub_a, shift_from(Un, d))
            insN = _sat(np.full_like(Un, io), Ui)
            insI = _sat(np.full_like(Un, ie), Ui)
            R = (np.minimum(diagc, insN), np.minimum(diagc, insI), np.minimum(diagc, insN))
            U = close_adj(R)
            RN[m] = U[0]
        self.RN = RN


class TracebackEngine(_tb.TracebackEngine):
    """The shared traceback, JAX-free."""

    def _column(self, pk, sk, dk, spec, p1, b) -> ModuleColumn:
        key = (pk, sk, dk, p1, b)
        if key not in self._columns:
            self._columns[key] = ModuleColumn(
                spec, self.config, self.ref, self.qry, b, p1, self.allow_sdel
            )
        return self._columns[key]

    def _exit_module(self, pk, sk, dk, spec, p2) -> ExitModule:
        key = (pk, sk, dk, p2)
        if not hasattr(self, "_exit_modules"):
            self._exit_modules = {}
        if key not in self._exit_modules:
            self._exit_modules[key] = ExitModule(
                spec, self.config, self.ref, self.qry, p2, self.allow_sdel
            )
        return self._exit_modules[key]

    def trace(
        self,
        primary_fields: List,
        reentry_fields: List,
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
            if fi == self.R and g == GAP_NONE and (i, j) == root_pos and v == 0:
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
            A_cells = primary_fields[k - 1].entry_cells()
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
