"""Exact re-pricer: compute the cost of a given RLE alignment.

Mirrors the reference's `compute_cost` used by the equal-cost-range
postprocessing (lib_tsalign/src/a_star_aligner/alignment_result/
template_switch_specifics.rs:591) and serves as an independent validator for
the dense engine's traceback: replay the op stream with full cursor and
flank bookkeeping and sum edge costs under the config.

Pricing rules replicated:
  * gap open vs extend decided by the previous gap state per context
    (context.rs:262-354);
  * flank ops: right-flank table for the first `right_flank_length` flank
    ops after a reentry (flank index < 0), left-flank table otherwise;
  * entrance: base cost + telescoped offset-walk cost, including the
    forward first-offset quirk (the entrance pays offset(0) standing at
    fo = +-1, context.rs:357-462);
  * secondary: per-char costs from the direction's table; reverse reads
    complement(secondary[s_idx - 1]) (context.rs:534-541);
  * exit: length(l) + length_difference(ag - l) + anti_primary_gap(ag).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import alignment as at
from .alignment import Alignment
from .config import TemplateSwitchConfig
from .costs import INF, sat_add
from .geometry import AlignmentRange

GAP_NONE, GAP_INS, GAP_DEL = 0, 1, 2


def _eval(fn, x: int) -> int:
    return fn.evaluate(x) if x >= fn.points[0][0] else INF


def price_alignment(
    config: TemplateSwitchConfig,
    reference: np.ndarray,
    query: np.ndarray,
    alignment: Alignment,
    range_: Optional[AlignmentRange] = None,
) -> int:
    """Total cost of `alignment` starting at the range offsets; INF if any
    edge is impossible/infinitely priced."""
    cfg = config
    ref = np.asarray(reference)
    qry = np.asarray(query)
    rng = range_ or AlignmentRange.complete(len(ref), len(qry))
    comp = cfg.alphabet.complement_array()

    i, j = rng.reference_offset, rng.query_offset
    flank = 0
    gap = GAP_NONE
    total = 0

    # In-TSM state
    in_ts = False
    pk = sk = dk = None
    ei = ej = 0  # entrance coordinates
    p_idx = 0  # primary index within TSM
    s_idx = 0  # secondary index within TSM
    ts_len = 0

    def sub_cost(table, c1, c2):
        return int(table.substitution[c1, c2])

    ops = list(alignment.entries)
    for n, t in ops:
        if isinstance(t, at.TemplateSwitchEntrance):
            pk = 0 if t.primary == "Reference" else 1
            sk = 0 if t.secondary == "Reference" else 1
            dk = 0 if t.direction == "Forward" else 1
            base = cfg.get_base_cost(t.primary, t.secondary, t.direction)
            off = cfg.offset_costs(t.primary, t.secondary)
            fo = t.first_offset
            off0 = _eval(off, 0)
            if base >= INF or off0 >= INF:
                return INF
            if dk == 1:
                walk = _eval(off, fo)
            else:
                if fo == 0:
                    return INF
                sign = 1 if fo > 0 else -1
                if abs(fo) == 1:
                    walk = off0
                else:
                    offs = _eval(off, sign)
                    offf = _eval(off, fo)
                    if offf >= INF or offs >= INF:
                        return INF
                    walk = off0 + offf - offs
            if walk >= INF:
                return INF
            total = sat_add(total, sat_add(base, walk))
            if total >= INF:
                return INF
            in_ts = True
            ei, ej = i, j
            e_s = (ei if sk == 0 else ej) + fo
            p_idx = ei if pk == 0 else ej
            s_idx = e_s
            ts_len = 0
            gap = GAP_NONE
            continue
        if isinstance(t, at.TemplateSwitchExit):
            if not in_ts:
                return INF
            ag = t.anti_primary_gap
            lc = _eval(cfg.length_costs, ts_len)
            dc = _eval(cfg.length_difference_costs, ag - ts_len)
            ac = _eval(cfg.anti_primary_gap_costs("Forward" if dk == 0 else "Reverse"), ag)
            if lc >= INF or dc >= INF or ac >= INF:
                return INF
            total = sat_add(total, lc + dc + ac)
            # reentry
            if pk == 0:
                i, j = p_idx, ej + ag
                if not (0 <= j < len(qry)):
                    return INF
            else:
                i, j = ei + ag, p_idx
                if not (0 <= i < len(ref)):
                    return INF
            flank = -cfg.right_flank_length
            gap = GAP_NONE
            in_ts = False
            continue

        # repeatable string ops
        for _ in range(n):
            if t in (
                at.PRIMARY_MATCH,
                at.PRIMARY_SUBSTITUTION,
                at.PRIMARY_FLANK_MATCH,
                at.PRIMARY_FLANK_SUBSTITUTION,
                at.PRIMARY_INSERTION,
                at.PRIMARY_DELETION,
                at.PRIMARY_FLANK_INSERTION,
                at.PRIMARY_FLANK_DELETION,
            ):
                is_flank = t.startswith("PrimaryFlank")
                if is_flank:
                    table = (
                        cfg.right_flank_edit_costs
                        if flank < 0
                        else cfg.left_flank_edit_costs
                    )
                else:
                    table = cfg.primary_edit_costs
                if t.endswith(("Match", "Substitution")):
                    if i >= len(ref) or j >= len(qry):
                        return INF
                    c = sub_cost(table, int(ref[i]), int(qry[j]))
                    i, j = i + 1, j + 1
                    gap = GAP_NONE
                elif t.endswith("Deletion"):
                    if i >= len(ref):
                        return INF
                    c = table.gap_cost(int(ref[i]), gap != GAP_DEL)
                    i += 1
                    gap = GAP_DEL
                else:  # Insertion
                    if j >= len(qry):
                        return INF
                    c = table.gap_cost(int(qry[j]), gap != GAP_INS)
                    j += 1
                    gap = GAP_INS
                if is_flank:
                    flank += 1
                else:
                    if flank != 0:
                        return INF
                total = sat_add(total, c)
            elif t in (
                at.SECONDARY_MATCH,
                at.SECONDARY_SUBSTITUTION,
                at.SECONDARY_DELETION,
                at.SECONDARY_INSERTION,
            ):
                if not in_ts:
                    return INF
                primary_seq = ref if pk == 0 else qry
                secondary_seq = ref if sk == 0 else qry
                table = cfg.secondary_edit_costs("Forward" if dk == 0 else "Reverse")

                def schar():
                    if dk == 0:
                        if not (0 <= s_idx < len(secondary_seq)):
                            return None
                        return int(secondary_seq[s_idx])
                    if not (0 < s_idx <= len(secondary_seq)):
                        return None
                    return int(comp[int(secondary_seq[s_idx - 1])])

                bonus = cfg.secondary_length_bonus
                if t in (at.SECONDARY_MATCH, at.SECONDARY_SUBSTITUTION):
                    s = schar()
                    if s is None or p_idx >= len(primary_seq):
                        return INF
                    c = sub_cost(table, int(primary_seq[p_idx]), s)
                    c = c - bonus if c < INF else c
                    p_idx += 1
                    s_idx += 1 if dk == 0 else -1
                    ts_len += 1
                    gap = GAP_NONE
                elif t == at.SECONDARY_DELETION:
                    s = schar()
                    if s is None:
                        return INF
                    c = table.gap_cost(s, gap != GAP_DEL)
                    s_idx += 1 if dk == 0 else -1
                    gap = GAP_DEL
                else:  # SecondaryInsertion
                    if p_idx >= len(primary_seq):
                        return INF
                    c = table.gap_cost(int(primary_seq[p_idx]), gap != GAP_INS)
                    c = c - bonus if c < INF else c
                    p_idx += 1
                    ts_len += 1
                    gap = GAP_INS
                total = sat_add(total, c)
            elif at.is_internal(t):
                continue
            else:
                raise ValueError(f"unknown op {t!r}")
            if total >= INF:
                return INF
    return total
