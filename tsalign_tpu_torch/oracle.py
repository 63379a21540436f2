"""Exact sparse-search oracle for the template-switch alignment problem.

This is a direct, executable specification of the reference's search graph
(lib_tsalign/src/a_star_aligner/template_switch_distance/context.rs:125-761 and
template_switch_distance.rs:89-728), implemented as a plain Dijkstra over the
same state space.  It is NOT the TPU compute path — it exists so that the
dense wavefront engine (ops/) can be property-tested against exact reference
semantics on small inputs, and as a debugging tool.

States:
  ("P",  ref_idx, query_idx, gap_type, flank_index)           Primary / PrimaryReentry
  ("E",  e_ref, e_query, pk, sk, dk, first_offset)            TemplateSwitchEntrance
  ("S",  e_ref, e_query, pk, sk, dk, primary_index,
         secondary_index, gap_type)                           Secondary
         (the reference also keys `length`, but length ==
          primary_index - entrance_primary_index always:
          identifier.rs:329-422 increments length exactly when
          primary_index increments)
  ("X",  e_ref, e_query, pk, sk, dk, primary_index, anti_gap) TemplateSwitchExit

gap_type: 0 = None, 1 = Insertion, 2 = Deletion
pk / sk: 0 = Reference, 1 = Query;  dk: 0 = Forward, 1 = Reverse

When ``max_template_switches`` is finite, the completed-TSM count is appended
to every state (template_switch_count strategy, strategies/template_switch_count.rs).
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from .alignment import (
    Alignment,
    EqualCostRange,
    TemplateSwitchEntrance,
    TemplateSwitchExit,
)
from .config import TemplateSwitchConfig
from .costs import INF
from .geometry import AlignmentRange

GAP_NONE, GAP_INS, GAP_DEL = 0, 1, 2

_PK = ("Reference", "Query")
_DK = ("Forward", "Reverse")


class OracleAligner:
    def __init__(
        self,
        config: TemplateSwitchConfig,
        reference: np.ndarray,
        query: np.ndarray,
        range_: Optional[AlignmentRange] = None,
        max_template_switches: Optional[int] = None,
        prune_range: bool = False,
    ):
        self.config = config
        self.ref = np.asarray(reference)
        self.qry = np.asarray(query)
        self.range = range_ or AlignmentRange.complete(len(self.ref), len(self.qry))
        self.max_ts = max_template_switches
        self.comp = config.alphabet.complement_array()
        # NoPrunePrimaryRangeStrategy (the CLI default) lets primary steps
        # roam the full sequences; only root/target use the range.
        if prune_range:
            self.ref_lo, self.ref_hi = self.range.reference_offset, self.range.reference_limit
            self.qry_lo, self.qry_hi = self.range.query_offset, self.range.query_limit
        else:
            self.ref_lo, self.ref_hi = 0, len(self.ref)
            self.qry_lo, self.qry_hi = 0, len(self.qry)

    # -- cost helpers -----------------------------------------------------

    def _sub(self, table, c1: int, c2: int) -> int:
        return int(table.substitution[c1, c2])

    def _gap(self, table, c: int, is_open: bool) -> int:
        return int(table.gap_open[c] if is_open else table.gap_extend[c])

    # -- successor generation (mirrors context.rs:125-729) ----------------

    def successors(self, state) -> List[Tuple[int, tuple, object]]:
        """Yield (cost_increment, successor_state, edge_type)."""
        cfg = self.config
        kind = state[0]
        out: List[Tuple[int, tuple, object]] = []

        if self.max_ts is not None:
            ts_count = state[-1]
            state = state[:-1]
            can_start = ts_count < self.max_ts
        else:
            ts_count = None
            can_start = True

        def emit(cost, succ, edge, inc_count=False):
            if cost >= INF:
                return
            if ts_count is not None:
                succ = succ + ((ts_count + 1) if inc_count else ts_count,)
            out.append((cost, succ, edge))

        if kind == "P":
            _, i, j, gap_type, flank = state
            L = cfg.left_flank_length
            R = cfg.right_flank_length

            in_ref = self.ref_lo <= i < self.ref_hi
            in_qry = self.qry_lo <= j < self.qry_hi

            if in_ref and in_qry:
                r = int(self.ref[i])
                q = int(self.qry[j])
                is_match = r == q
                if flank == 0:
                    c = self._sub(cfg.primary_edit_costs, r, q)
                    edge = "PrimaryMatch" if is_match else "PrimarySubstitution"
                    emit(c, ("P", i + 1, j + 1, GAP_NONE, 0), edge)
                if (0 <= flank < L and can_start) or flank < 0:
                    table = cfg.right_flank_edit_costs if flank < 0 else cfg.left_flank_edit_costs
                    c = self._sub(table, r, q)
                    edge = "PrimaryFlankMatch" if is_match else "PrimaryFlankSubstitution"
                    emit(c, ("P", i + 1, j + 1, GAP_NONE, flank + 1), edge)

            if in_ref:
                r = int(self.ref[i])
                if flank == 0:
                    c = self._gap(cfg.primary_edit_costs, r, gap_type != GAP_DEL)
                    emit(c, ("P", i + 1, j, GAP_DEL, 0), "PrimaryDeletion")
                if 0 <= flank < L and can_start:
                    c = self._gap(cfg.left_flank_edit_costs, r, gap_type != GAP_DEL)
                    emit(c, ("P", i + 1, j, GAP_DEL, flank + 1), "PrimaryFlankDeletion")
                elif flank < 0:
                    c = self._gap(cfg.right_flank_edit_costs, r, gap_type != GAP_DEL)
                    emit(c, ("P", i + 1, j, GAP_DEL, flank + 1), "PrimaryFlankDeletion")

            if in_qry:
                q = int(self.qry[j])
                if flank == 0:
                    c = self._gap(cfg.primary_edit_costs, q, gap_type != GAP_INS)
                    emit(c, ("P", i, j + 1, GAP_INS, 0), "PrimaryInsertion")
                if 0 <= flank < L and can_start:
                    c = self._gap(cfg.left_flank_edit_costs, q, gap_type != GAP_INS)
                    emit(c, ("P", i, j + 1, GAP_INS, flank + 1), "PrimaryFlankInsertion")
                elif flank < 0:
                    c = self._gap(cfg.right_flank_edit_costs, q, gap_type != GAP_INS)
                    emit(c, ("P", i, j + 1, GAP_INS, flank + 1), "PrimaryFlankInsertion")

            # Template switch entrances (context.rs:357-374)
            if flank == L and can_start:
                rq_qr0 = cfg.rq_qr_offset_costs.evaluate(0)
                rr_qq0 = cfg.rr_qq_offset_costs.evaluate(0)
                if rq_qr0 < INF or rr_qq0 < INF:
                    for pk in (0, 1):
                        for sk in (0, 1):
                            offset0 = rr_qq0 if pk == sk else rq_qr0
                            for dk in (0, 1):
                                base = cfg.get_base_cost(_PK[pk], _PK[sk], _DK[dk])
                                if base >= INF or offset0 >= INF:
                                    continue
                                first_offsets = (-1, 1) if dk == 0 else (0,)
                                for fo in first_offsets:
                                    emit(
                                        base + offset0,
                                        ("E", i, j, pk, sk, dk, fo),
                                        TemplateSwitchEntrance(
                                            first_offset=fo,
                                            equal_cost_range=EqualCostRange.new_invalid(),
                                            primary=_PK[pk],
                                            secondary=_PK[sk],
                                            direction=_DK[dk],
                                        ),
                                    )

        elif kind == "E":
            _, ei, ej, pk, sk, dk, fo = state
            sec_len = len(self.ref) if sk == 0 else len(self.qry)
            sec_entrance = ei if sk == 0 else ej
            sec_idx = sec_entrance + fo
            offset_costs = cfg.offset_costs(_PK[pk], _PK[sk])
            min_len = cfg.template_switch_min_length

            # Walk offset upward (context.rs:401-432)
            if fo >= 0 and (
                (dk == 0 and sec_idx + min_len < sec_len) or (dk == 1 and sec_idx < sec_len)
            ):
                new_cost = offset_costs.evaluate(fo + 1)
                if new_cost < INF:
                    old_cost = offset_costs.evaluate(fo)
                    emit(
                        new_cost - old_cost,
                        ("E", ei, ej, pk, sk, dk, fo + 1),
                        TemplateSwitchEntrance(
                            first_offset=fo + 1,
                            equal_cost_range=EqualCostRange.new_invalid(),
                            primary=_PK[pk],
                            secondary=_PK[sk],
                            direction=_DK[dk],
                        ),
                    )
            # Walk offset downward (context.rs:434-462)
            if fo <= 0 and (
                (dk == 0 and sec_idx > 0) or (dk == 1 and sec_idx > min_len)
            ):
                new_cost = offset_costs.evaluate(fo - 1)
                if new_cost < INF:
                    old_cost = offset_costs.evaluate(fo)
                    emit(
                        new_cost - old_cost,
                        ("E", ei, ej, pk, sk, dk, fo - 1),
                        TemplateSwitchEntrance(
                            first_offset=fo - 1,
                            equal_cost_range=EqualCostRange.new_invalid(),
                            primary=_PK[pk],
                            secondary=_PK[sk],
                            direction=_DK[dk],
                        ),
                    )
            # Spawn secondary root (context.rs:464-488)
            if (dk == 0 and 0 <= sec_idx and sec_idx + min_len <= sec_len) or (
                dk == 1 and min_len <= sec_idx <= sec_len
            ):
                p_idx = ei if pk == 0 else ej
                emit(0, ("S", ei, ej, pk, sk, dk, p_idx, sec_idx, GAP_NONE), "SecondaryRoot")

        elif kind == "S":
            _, ei, ej, pk, sk, dk, p_idx, s_idx, gap_type = state
            primary_seq = self.ref if pk == 0 else self.qry
            secondary_seq = self.ref if sk == 0 else self.qry
            entrance_primary = ei if pk == 0 else ej
            length = p_idx - entrance_primary
            table = cfg.secondary_edit_costs(_DK[dk])

            bonus = cfg.secondary_length_bonus
            min_future_length_cost = cfg.length_costs.min_from(length)
            if min_future_length_cost is not None and min_future_length_cost < INF:
                sec_ok = s_idx < len(secondary_seq) if dk == 0 else s_idx > 0
                if p_idx < len(primary_seq) and sec_ok:
                    p = int(primary_seq[p_idx])
                    if dk == 0:
                        s = int(secondary_seq[s_idx])
                    else:
                        s = int(self.comp[int(secondary_seq[s_idx - 1])])
                    c = self._sub(table, p, s)
                    c = c - bonus if c < INF else c
                    edge = "SecondaryMatch" if p == s else "SecondarySubstitution"
                    ns = s_idx + 1 if dk == 0 else s_idx - 1
                    emit(c, ("S", ei, ej, pk, sk, dk, p_idx + 1, ns, GAP_NONE), edge)
                if sec_ok:
                    if dk == 0:
                        s = int(secondary_seq[s_idx])
                    else:
                        s = int(self.comp[int(secondary_seq[s_idx - 1])])
                    c = self._gap(table, s, gap_type != GAP_DEL)
                    ns = s_idx + 1 if dk == 0 else s_idx - 1
                    emit(c, ("S", ei, ej, pk, sk, dk, p_idx, ns, GAP_DEL), "SecondaryDeletion")
                if p_idx < len(primary_seq):
                    p = int(primary_seq[p_idx])
                    c = self._gap(table, p, gap_type != GAP_INS)
                    c = c - bonus if c < INF else c
                    emit(c, ("S", ei, ej, pk, sk, dk, p_idx + 1, s_idx, GAP_INS), "SecondaryInsertion")

            # Initial exit (context.rs:622-633)
            length_cost = cfg.length_costs.evaluate(length)
            ldiff0 = cfg.length_difference_costs.evaluate(0)
            if length_cost < INF and ldiff0 < INF:
                emit(
                    length_cost + ldiff0,
                    ("X", ei, ej, pk, sk, dk, p_idx, length),
                    TemplateSwitchExit(anti_primary_gap=length),
                )

        elif kind == "X":
            _, ei, ej, pk, sk, dk, p_idx, anti_gap = state
            if pk == 0:
                anti_lo, anti_hi = self.qry_lo, self.qry_hi
                entrance_primary = ei
            else:
                anti_lo, anti_hi = self.ref_lo, self.ref_hi
                entrance_primary = ej
            ldiff = anti_gap - (p_idx - entrance_primary)

            # Walk anti-primary gap (context.rs:662-707); note the reference
            # bounds the walk by primary_index + length_difference vs the
            # anti range, using the primary index as a proxy.
            if ldiff >= 0 and p_idx + ldiff < anti_hi:
                new_cost = cfg.length_difference_costs.evaluate(ldiff + 1)
                if new_cost < INF:
                    old_cost = cfg.length_difference_costs.evaluate(ldiff)
                    emit(
                        new_cost - old_cost,
                        ("X", ei, ej, pk, sk, dk, p_idx, anti_gap + 1),
                        TemplateSwitchExit(anti_primary_gap=anti_gap + 1),
                    )
            if ldiff <= 0 and p_idx + ldiff > anti_lo:
                new_cost = cfg.length_difference_costs.evaluate(ldiff - 1)
                if new_cost < INF:
                    old_cost = cfg.length_difference_costs.evaluate(ldiff)
                    emit(
                        new_cost - old_cost,
                        ("X", ei, ej, pk, sk, dk, p_idx, anti_gap - 1),
                        TemplateSwitchExit(anti_primary_gap=anti_gap - 1),
                    )

            # Reentry (template_switch_distance.rs:579-644)
            gap_cost = cfg.anti_primary_gap_costs(_DK[dk]).evaluate(anti_gap)
            if gap_cost < INF:
                if pk == 0:
                    nj = ej + anti_gap
                    if 0 <= nj < len(self.qry):
                        emit(
                            gap_cost,
                            ("P", p_idx, nj, GAP_NONE, -cfg.right_flank_length),
                            "PrimaryReentry",
                            inc_count=True,
                        )
                else:
                    ni = ei + anti_gap
                    if 0 <= ni < len(self.ref):
                        emit(
                            gap_cost,
                            ("P", ni, p_idx, GAP_NONE, -cfg.right_flank_length),
                            "PrimaryReentry",
                            inc_count=True,
                        )

        return out

    # -- search ------------------------------------------------------------

    def root(self) -> tuple:
        s = ("P", self.range.reference_offset, self.range.query_offset, GAP_NONE, 0)
        if self.max_ts is not None:
            s = s + (0,)
        return s

    def is_target(self, state) -> bool:
        if state[0] != "P":
            return False
        return (
            state[1] == self.range.reference_limit
            and state[2] == self.range.query_limit
        )

    def align(self, cost_limit: Optional[int] = None):
        """Dijkstra; returns (cost, alignment) or (None, None) if no target."""
        dist: Dict[tuple, int] = {}
        pred: Dict[tuple, Tuple[tuple, object]] = {}
        root = self.root()
        heap: List[Tuple[int, int, tuple]] = [(0, 0, root)]
        dist[root] = 0
        counter = 1
        target = None
        while heap:
            d, _, state = heapq.heappop(heap)
            if d != dist.get(state, -1):
                continue
            if cost_limit is not None and d > cost_limit:
                return None, None
            if self.is_target(state):
                target = state
                break
            for inc, succ, edge in self.successors(state):
                nd = d + inc
                if cost_limit is not None and nd > cost_limit:
                    continue
                if nd < dist.get(succ, INF):
                    dist[succ] = nd
                    pred[succ] = (state, edge)
                    heapq.heappush(heap, (nd, counter, succ))
                    counter += 1
        if target is None:
            return None, None

        edges = []
        state = target
        while state in pred:
            state, edge = pred[state]
            edges.append(edge)
        edges.reverse()
        return dist[target], Alignment.from_edge_sequence(edges)
