"""Alignment postprocessing: equal-cost ranges and range extension.

Mirrors lib_tsalign/src/a_star_aligner/alignment_result.rs:247-560 and
alignment_result/alignment/template_switch_specifics.rs:30-589:

  * `compute_ts_equal_cost_ranges`: for every template switch, determine how
    far its start (SP1/SP2) and end (SP3/SP4) can shift at equal cost by
    repeatedly moving one char pair in/out of the TSM and re-pricing;
  * `extend_beyond_range_without_increasing_cost`: greedily extend a
    range-restricted alignment with primary char pairs while the total cost
    does not increase.

Both skip flanked configs (the reference warns and no-ops, since its
compute_cost does not support flanks).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from . import alignment as at
from .alignment import Alignment, EqualCostRange, TemplateSwitchEntrance, TemplateSwitchExit
from .config import TemplateSwitchConfig
from .costs import INF
from .geometry import AlignmentRange
from .pricing import price_alignment

Entries = List[Tuple[int, object]]


def _advance(i: int, j: int, entries: Entries, in_ts_primary=None):
    """Head coordinates after replaying `entries` from (i, j), mirroring
    AlignmentStream (alignment/stream.rs)."""
    pk = sk = dk = None
    p_idx = s_idx = 0
    for count, t in entries:
        if isinstance(t, TemplateSwitchEntrance):
            pk = t.primary
            p_idx = i if pk == "Reference" else j
        elif isinstance(t, TemplateSwitchExit):
            ag = t.anti_primary_gap
            if pk == "Reference":
                i, j = p_idx, j + ag
            else:
                i, j = i + ag, p_idx
            pk = None
        elif isinstance(t, str) and t.startswith("Secondary"):
            if t in (at.SECONDARY_MATCH, at.SECONDARY_SUBSTITUTION, at.SECONDARY_INSERTION):
                p_idx += count
        else:
            if t.endswith(("Match", "Substitution")):
                i += count
                j += count
            elif t.endswith("Deletion"):
                i += count
            elif t.endswith("Insertion"):
                j += count
    return i, j


def _secondary_entry_index(entries: Entries, idx: int, ref_off: int, qry_off: int):
    """(i, j) at the entrance with compact index idx."""
    return _advance(ref_off, qry_off, entries[:idx])


def _get_seq(which: str, ref, qry):
    return ref if which == "Reference" else qry


def _dec_entry(entries: Entries, idx: int) -> bool:
    n, t = entries[idx]
    if n == 0:
        return False
    if n == 1:
        entries.pop(idx)
        return True
    entries[idx] = (n - 1, t)
    return True


def _inc_or_insert(entries: Entries, idx: int, t) -> None:
    if 0 <= idx < len(entries) and entries[idx][1] == t:
        entries[idx] = (entries[idx][0] + 1, t)
    else:
        entries.insert(max(idx, 0), (1, t))


def _find_exit(entries: Entries, start: int) -> Optional[int]:
    for k in range(start, len(entries)):
        if isinstance(entries[k][1], TemplateSwitchExit):
            return k
    return None


def _fix_anti_gap(entries: Entries, start: int, delta: int) -> None:
    k = _find_exit(entries, start)
    n, t = entries[k]
    entries[k] = (n, TemplateSwitchExit(anti_primary_gap=t.anti_primary_gap + delta))


def _set_first_offset(entries: Entries, idx: int, delta: int) -> None:
    n, e = entries[idx]
    entries[idx] = (
        n,
        TemplateSwitchEntrance(
            first_offset=e.first_offset + delta,
            equal_cost_range=e.equal_cost_range,
            primary=e.primary,
            secondary=e.secondary,
            direction=e.direction,
        ),
    )


def move_ts_start_backwards(entries, ref, qry, ref_off, qry_off, idx: int):
    """template_switch_specifics.rs:30-180.  Returns new idx or None."""
    n, e = entries[idx]
    if not isinstance(e, TemplateSwitchEntrance):
        return None
    if idx == 0 or entries[idx - 1][1] not in (at.PRIMARY_MATCH, at.PRIMARY_SUBSTITUTION):
        return None
    i, j = _secondary_entry_index(entries, idx, ref_off, qry_off)
    primary_seq = _get_seq(e.primary, ref, qry)
    secondary_seq = _get_seq(e.secondary, ref, qry)
    p_in = i if e.primary == "Reference" else j
    if p_in == 0:
        return None
    s_in = (i if e.secondary == "Reference" else j) + e.first_offset
    if s_in < 0:
        return None
    if e.direction == "Forward" and s_in == 0:
        return None
    if e.direction == "Reverse" and s_in >= len(secondary_seq):
        return None

    before = len(entries)
    if not _dec_entry(entries, idx - 1):
        return None
    if len(entries) < before:
        idx -= 1

    pc = int(primary_seq[p_in - 1])
    if e.direction == "Forward":
        sc = int(secondary_seq[s_in - 1])
    else:
        sc = int(_COMP[int(secondary_seq[s_in])])
    inner = at.SECONDARY_MATCH if pc == sc else at.SECONDARY_SUBSTITUTION
    if idx + 1 < len(entries) and entries[idx + 1][1] == inner:
        n2, t2 = entries[idx + 1]
        entries[idx + 1] = (n2 + 1, t2)
    else:
        entries.insert(idx + 1, (1, inner))
    if e.direction == "Reverse":
        _set_first_offset(entries, idx, +2)
    _fix_anti_gap(entries, idx, +1)
    return idx


def move_ts_start_forwards(entries, ref, qry, ref_off, qry_off, idx: int):
    """template_switch_specifics.rs:182-296."""
    n, e = entries[idx]
    if not isinstance(e, TemplateSwitchEntrance):
        return None
    if idx > 0 and isinstance(entries[idx - 1][1], str) and entries[idx - 1][1].startswith(
        "PrimaryFlank"
    ):
        return None
    if idx + 1 >= len(entries) or entries[idx + 1][1] not in (
        at.SECONDARY_MATCH,
        at.SECONDARY_SUBSTITUTION,
    ):
        return None
    i, j = _secondary_entry_index(entries, idx, ref_off, qry_off)
    if i == len(ref) or j == len(qry):
        return None
    if not _dec_entry(entries, idx + 1):
        return None
    rc, qc = int(ref[i]), int(qry[j])
    outer = at.PRIMARY_MATCH if rc == qc else at.PRIMARY_SUBSTITUTION
    if idx > 0 and entries[idx - 1][1] == outer:
        n2, t2 = entries[idx - 1]
        entries[idx - 1] = (n2 + 1, t2)
    else:
        entries.insert(idx, (1, outer))
        idx += 1
    if e.direction == "Reverse":
        _set_first_offset(entries, idx, -2)
    _fix_anti_gap(entries, idx, -1)
    return idx


def move_ts_end_forwards(entries, ref, qry, ref_off, qry_off, idx: int) -> bool:
    """template_switch_specifics.rs:305-475."""
    n, e = entries[idx]
    if not isinstance(e, TemplateSwitchEntrance):
        return False
    exit_index = _find_exit(entries, idx)
    if exit_index is None:
        return False
    inner_secondary_length = sum(
        m
        for m, t in entries[idx + 1 : exit_index]
        if t in (at.SECONDARY_DELETION, at.SECONDARY_SUBSTITUTION, at.SECONDARY_MATCH)
    )
    if exit_index + 1 >= len(entries) or entries[exit_index + 1][1] not in (
        at.PRIMARY_MATCH,
        at.PRIMARY_SUBSTITUTION,
    ):
        return False
    # head coordinates after the exit (reentry point)
    i2, j2 = _advance(ref_off, qry_off, entries[: exit_index + 1])
    # tail coordinates = entrance point
    ti, tj = _secondary_entry_index(entries, idx, ref_off, qry_off)
    primary_seq = _get_seq(e.primary, ref, qry)
    secondary_seq = _get_seq(e.secondary, ref, qry)
    p_in = i2 if e.primary == "Reference" else j2
    s_base = (ti if e.secondary == "Reference" else tj) + e.first_offset
    if s_base < 0:
        return False
    if e.direction == "Forward":
        s_in = s_base + inner_secondary_length
        if s_in >= len(secondary_seq):
            return False
    else:
        s_in = s_base - inner_secondary_length
        if s_in <= 0:
            return False
    if p_in >= len(primary_seq):
        return False

    if not _dec_entry(entries, exit_index + 1):
        return False
    pc = int(primary_seq[p_in])
    if e.direction == "Forward":
        sc = int(secondary_seq[s_in])
    else:
        sc = int(_COMP[int(secondary_seq[s_in - 1])])
    inner = at.SECONDARY_MATCH if pc == sc else at.SECONDARY_SUBSTITUTION
    if entries[exit_index - 1][1] == inner:
        n2, t2 = entries[exit_index - 1]
        entries[exit_index - 1] = (n2 + 1, t2)
    else:
        entries.insert(exit_index, (1, inner))
        exit_index += 1
    _fix_anti_gap(entries, idx, +1)
    return True


def move_ts_end_backwards(entries, ref, qry, ref_off, qry_off, idx: int) -> bool:
    """template_switch_specifics.rs:477-589."""
    n, e = entries[idx]
    if not isinstance(e, TemplateSwitchEntrance):
        return False
    exit_index = _find_exit(entries, idx)
    if exit_index is None:
        return False
    if exit_index + 1 < len(entries) and isinstance(
        entries[exit_index + 1][1], str
    ) and entries[exit_index + 1][1].startswith("PrimaryFlank"):
        return False
    if entries[exit_index - 1][1] not in (at.SECONDARY_MATCH, at.SECONDARY_SUBSTITUTION):
        return False
    i2, j2 = _advance(ref_off, qry_off, entries[: exit_index + 1])
    if i2 == 0 or j2 == 0:
        return False
    before = len(entries)
    if not _dec_entry(entries, exit_index - 1):
        return False
    if len(entries) < before:
        exit_index -= 1
    rc, qc = int(ref[i2 - 1]), int(qry[j2 - 1])
    outer = at.PRIMARY_MATCH if rc == qc else at.PRIMARY_SUBSTITUTION
    if exit_index + 1 < len(entries) and entries[exit_index + 1][1] == outer:
        n2, t2 = entries[exit_index + 1]
        entries[exit_index + 1] = (n2 + 1, t2)
    else:
        entries.insert(exit_index + 1, (1, outer))
    _fix_anti_gap(entries, idx, -1)
    return True


_COMP = None  # set per call


def compute_ts_equal_cost_ranges(
    alignment: Alignment,
    config: TemplateSwitchConfig,
    reference: np.ndarray,
    query: np.ndarray,
    range_: AlignmentRange,
) -> None:
    """In-place: fill each entrance's equal_cost_range
    (alignment_result.rs:398-560)."""
    global _COMP
    if config.left_flank_length > 0 or config.right_flank_length > 0:
        return
    _COMP = config.alphabet.complement_array()
    ref = np.asarray(reference)
    qry = np.asarray(query)
    ro, qo = range_.reference_offset, range_.query_offset

    def cost_of(entries: Entries) -> int:
        return price_alignment(config, ref, qry, Alignment(list(entries)), range_=range_)

    for i in range(len(alignment.entries)):
        nmul, t = alignment.entries[i]
        if not isinstance(t, TemplateSwitchEntrance):
            continue
        ecr = {"min_start": 0, "max_start": 0, "min_end": 0, "max_end": 0}
        current_cost = cost_of(alignment.entries)

        work = [list(e) for e in alignment.entries]
        work = [tuple(e) for e in work]
        w = list(work)
        k = i
        while True:
            k2 = move_ts_start_backwards(w, ref, qry, ro, qo, k)
            if k2 is None:
                break
            k = k2
            new_cost = cost_of(w)
            if new_cost > current_cost:
                break
            current_cost = new_cost
            ecr["min_start"] -= 1

        w = list(work)
        k = i
        while True:
            k2 = move_ts_start_forwards(w, ref, qry, ro, qo, k)
            if k2 is None:
                break
            k = k2
            new_cost = cost_of(w)
            if new_cost > current_cost:
                break
            current_cost = new_cost
            ecr["max_start"] += 1

        w = list(work)
        while move_ts_end_backwards(w, ref, qry, ro, qo, i):
            new_cost = cost_of(w)
            if new_cost > current_cost:
                break
            current_cost = new_cost
            ecr["min_end"] -= 1

        w = list(work)
        while move_ts_end_forwards(w, ref, qry, ro, qo, i):
            new_cost = cost_of(w)
            if new_cost > current_cost:
                break
            current_cost = new_cost
            ecr["max_end"] += 1

        alignment.entries[i] = (
            nmul,
            TemplateSwitchEntrance(
                first_offset=t.first_offset,
                equal_cost_range=EqualCostRange(**ecr),
                primary=t.primary,
                secondary=t.secondary,
                direction=t.direction,
            ),
        )


def extend_beyond_range(
    alignment: Alignment,
    config: TemplateSwitchConfig,
    reference: np.ndarray,
    query: np.ndarray,
    range_: AlignmentRange,
) -> AlignmentRange:
    """Greedy equal-cost extension beyond the focus range
    (alignment_result.rs:247-395).  Returns the widened range."""
    if config.left_flank_length > 0 or config.right_flank_length > 0:
        return range_
    ref = np.asarray(reference)
    qry = np.asarray(query)
    ro, qo = range_.reference_offset, range_.query_offset
    rl, ql = range_.reference_limit, range_.query_limit

    def cost_of(entries, r_off, q_off) -> int:
        return price_alignment(
            config,
            ref,
            qry,
            Alignment(list(entries)),
            range_=AlignmentRange(r_off, q_off, rl, ql),
        )

    entries = alignment.entries
    current_cost = cost_of(entries, ro, qo)

    while ro > 0 and qo > 0:
        nro, nqo = ro - 1, qo - 1
        rc, qc = int(ref[nro]), int(qry[nqo])
        t = at.PRIMARY_MATCH if rc == qc else at.PRIMARY_SUBSTITUTION
        if entries and entries[0][1] == t:
            entries[0] = (entries[0][0] + 1, t)
        else:
            entries.insert(0, (1, t))
        new_cost = cost_of(entries, nro, nqo)
        if new_cost > current_cost:
            n0, t0 = entries[0]
            if n0 == 1:
                entries.pop(0)
            else:
                entries[0] = (n0 - 1, t0)
            break
        current_cost = new_cost
        ro, qo = nro, nqo

    while rl < len(ref) and ql < len(qry):
        nrl, nql = rl + 1, ql + 1
        rc, qc = int(ref[nrl - 1]), int(qry[nql - 1])
        t = at.PRIMARY_MATCH if rc == qc else at.PRIMARY_SUBSTITUTION
        if entries and entries[-1][1] == t:
            entries[-1] = (entries[-1][0] + 1, t)
        else:
            entries.append((1, t))
        new_cost = cost_of(entries, ro, qo)
        if new_cost > current_cost:
            nl, tl = entries[-1]
            if nl == 1:
                entries.pop()
            else:
                entries[-1] = (nl - 1, tl)
            break
        current_cost = new_cost
        rl, ql = nrl, nql

    return AlignmentRange(ro, qo, rl, ql)
