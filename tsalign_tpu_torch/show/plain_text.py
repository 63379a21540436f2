"""Plain-text rendering of template switches.

Behavioral counterpart of lib_tsshow/src/plain_text.rs:23-67 and
show_template_switch (:69-): for each TSM, render the context-windowed
multipair view — the anti-primary as base row, the primary's upstream (F1)
and downstream (F3) flanks aligned onto it, the complement row for reverse
switches, and the 2-3 inner alignment (F2) anchored at the secondary span —
plus the matching window of a no-TS alignment when one is supplied.
"""

from __future__ import annotations

from typing import List, Optional, TextIO, Tuple

from ..result import AlignmentResult
from .parse_template_switches import STREAM_PADDING, TSShow, parse
from .renderer import MultipairAlignmentRenderer, op_consumes


def _flat(ops) -> List[str]:
    out: List[str] = []
    for count, t in ops:
        out.extend([t] * count)
    return out


def _primary_pairs(ops, primary_is_reference: bool) -> List[Tuple[bool, bool]]:
    """(consumes_new=primary, consumes_base=anti-primary) pairs for primary
    ops (Deletion consumes reference, Insertion consumes query)."""
    pairs = []
    for t in ops:
        r, q = op_consumes(t)
        pairs.append((r, q) if primary_is_reference else (q, r))
    return pairs


def _inner_pairs(ops) -> List[Tuple[bool, bool]]:
    """(consumes_new=primary fragment, consumes_base=secondary row) pairs
    for secondary (2-3) ops: SecondaryDeletion consumes the secondary,
    SecondaryInsertion consumes the primary."""
    pairs = []
    for t in ops:
        if t.endswith(("Match", "Substitution")):
            pairs.append((True, True))
        elif t.endswith("Deletion"):
            pairs.append((False, True))
        elif t.endswith("Insertion"):
            pairs.append((True, False))
    return pairs


def _complement_forward(rc: str) -> str:
    """Complement in forward orientation (the reverse of the stored RC)."""
    return rc[::-1]


def render_ts(
    out: TextIO,
    result: AlignmentResult,
    ts: TSShow,
    index: int,
    no_ts_result: Optional[AlignmentResult] = None,
) -> None:
    e = ts.entrance
    seqs = result.sequences
    primary_is_ref = e.primary == "Reference"
    forward = ts.sp2_secondary < ts.sp3_secondary

    if primary_is_ref:
        primary_label, primary_name = "Parent", seqs.reference_name
        primary, primary_c = seqs.reference, _complement_forward(seqs.reference_rc)
        anti_label, anti_name = "Child", seqs.query_name
        anti, anti_c = seqs.query, _complement_forward(seqs.query_rc)
        p_of = lambda rq: rq[0]
        a_of = lambda rq: rq[1]
    else:
        primary_label, primary_name = "Child", seqs.query_name
        primary, primary_c = seqs.query, _complement_forward(seqs.query_rc)
        anti_label, anti_name = "Parent", seqs.reference_name
        anti, anti_c = seqs.reference, _complement_forward(seqs.reference_rc)
        p_of = lambda rq: rq[1]
        a_of = lambda rq: rq[0]

    same_seq = (e.primary == "Reference") == (e.secondary == "Reference")

    up_co = (ts.upstream_reference, ts.upstream_query)
    sp1_co = (ts.sp1_reference, ts.sp1_query)
    sp4_co = (ts.sp4_reference, ts.sp4_query)
    down_co = (ts.downstream_reference, ts.downstream_query)

    primary_offset, primary_limit = p_of(up_co), p_of(down_co)
    anti_f1_offset, anti_f3_offset = a_of(up_co), a_of(sp4_co)
    anti_offset = min(anti_f1_offset, anti_f3_offset)
    anti_f1_limit, anti_f3_limit = a_of(sp1_co), a_of(down_co)
    anti_limit = max(anti_f1_limit, anti_f3_limit)

    sp1_p, sp4_p = p_of(sp1_co), p_of(sp4_co)
    ts_inner = primary[sp1_p:sp4_p]
    inner_ops = _flat(ts.inner)
    if not forward:
        ts_inner = ts_inner[::-1]
        inner_ops = inner_ops[::-1]

    f1_label, f2_label, f3_label = (
        f"{primary_label}1",
        f"{primary_label}2",
        f"{primary_label}3",
    )
    s_lo = min(ts.sp2_secondary, ts.sp3_secondary)
    s_hi = max(ts.sp2_secondary, ts.sp3_secondary)

    out.write(f"{anti_label}: {anti_name}\n")
    out.write(f"{primary_label}: {primary_name}\n")
    out.write(f"Direction: {'forward' if forward else 'reverse'}\n")
    out.write("\n")
    out.write("Switch process:\n")

    if same_seq:
        # Outside view: anti-primary base with the F1/F3 flanks.
        anti_fwd = f"{anti_label}F"
        outside = MultipairAlignmentRenderer(
            anti_fwd, anti[anti_offset:anti_limit]
        )
        outside.add_aligned_sequence(
            anti_fwd,
            anti_f1_offset - anti_offset,
            f1_label,
            primary[primary_offset:sp1_p],
            _primary_pairs(_flat(ts.upstream), primary_is_ref),
        )
        outside.add_aligned_sequence(
            anti_fwd,
            anti_f3_offset - anti_offset,
            f3_label,
            primary[sp4_p:primary_limit],
            _primary_pairs(_flat(ts.downstream), primary_is_ref),
        )
        # Inside view: the primary (or its complement, for reverse) around
        # the secondary span with the inner alignment anchored on it.
        ext_offset = min(primary_offset, max(0, s_lo - STREAM_PADDING))
        ext_limit = max(primary_limit, min(len(primary), s_hi + STREAM_PADDING))
        base_label = f"{primary_label}F" if forward else f"{primary_label}R"
        base_seq = (primary if forward else primary_c)[ext_offset:ext_limit]
        inside = MultipairAlignmentRenderer(base_label, base_seq)
        inside.add_aligned_sequence(
            base_label,
            s_lo - ext_offset,
            f2_label,
            ts_inner,
            _inner_pairs(inner_ops),
        )
        outside.render(out, [f1_label, f3_label, anti_fwd])
        out.write("\n")
        inside.render(out, [base_label, f2_label])
    else:
        ext_offset = min(anti_offset, max(0, s_lo - STREAM_PADDING))
        ext_limit = max(anti_f3_limit, min(len(anti), s_hi + STREAM_PADDING))
        anti_fwd = f"{anti_label}F"
        anti_rev = f"{anti_label}R"
        renderer = MultipairAlignmentRenderer(
            anti_fwd, anti[ext_offset:ext_limit]
        )
        if not forward:
            renderer.add_aligned_sequence(
                anti_fwd,
                0,
                anti_rev,
                anti_c[ext_offset:ext_limit],
                [(True, True)] * (ext_limit - ext_offset),
                render_gaps=False,
            )
        renderer.add_aligned_sequence(
            anti_fwd,
            anti_f1_offset - ext_offset,
            f1_label,
            primary[primary_offset:sp1_p],
            _primary_pairs(_flat(ts.upstream), primary_is_ref),
        )
        renderer.add_aligned_sequence(
            anti_fwd,
            anti_f3_offset - ext_offset,
            f3_label,
            primary[sp4_p:primary_limit],
            _primary_pairs(_flat(ts.downstream), primary_is_ref),
        )
        renderer.add_aligned_sequence(
            anti_fwd if forward else anti_rev,
            s_lo - ext_offset,
            f2_label,
            ts_inner,
            _inner_pairs(inner_ops),
        )
        names = [f1_label, f3_label, anti_fwd]
        if not forward:
            names.append(anti_rev)
        names.append(f2_label)
        renderer.render(out, names)

    if no_ts_result is not None and no_ts_result.has_target:
        _render_no_ts_window(
            out,
            no_ts_result,
            primary_label,
            anti_label,
            primary,
            anti,
            p_of,
            a_of,
            anti_offset,
            anti_f3_limit,
            primary_is_ref,
        )
    out.write("\n")


def _render_no_ts_window(
    out,
    no_ts_result,
    primary_label,
    anti_label,
    primary,
    anti,
    p_of,
    a_of,
    anti_offset,
    anti_limit,
    primary_is_ref,
):
    """The matching window of the no-TS alignment (plain_text.rs:428-...):
    the stretch of the no-TS alignment whose anti-primary coordinates cover
    [anti_offset, anti_limit)."""
    ops = _flat(no_ts_result.alignment.entries)
    i, j = no_ts_result.reference_offset, no_ts_result.query_offset
    window_ops: List[str] = []
    p_start = p_end = None
    for t in ops:
        if a_of((i, j)) >= anti_limit:
            break
        r, q = op_consumes(t)
        in_window = a_of((i, j)) >= anti_offset
        if in_window:
            if p_start is None:
                p_start = p_of((i, j))
            window_ops.append(t)
        i += r
        j += q
        if in_window:
            p_end = p_of((i, j))
    if p_start is None:
        return
    out.write("\nNo-ts alignment:\n")
    renderer = MultipairAlignmentRenderer(
        anti_label, anti[anti_offset:anti_limit]
    )
    renderer.add_aligned_sequence(
        anti_label,
        0,
        primary_label,
        primary[p_start:p_end],
        _primary_pairs(window_ops, primary_is_ref),
    )
    renderer.render(out, [anti_label, primary_label])


def show_template_switches(
    out: TextIO,
    result: AlignmentResult,
    no_ts_result: Optional[AlignmentResult] = None,
) -> None:
    if not result.has_target:
        out.write("alignment has no target (search did not finish)\n")
        return
    switches = parse(result)
    out.write(f"CIGAR: {result.cigar()} (Cost: {int(result.cost)})\n")
    if no_ts_result is not None:
        out.write(
            f"No-ts CIGAR: {no_ts_result.cigar()} "
            f"(Cost: {int(no_ts_result.cost)})\n"
        )
    out.write(f"Found {len(switches)} template switches\n\n")
    for k, ts in enumerate(switches, 1):
        out.write(f"Showing template switch {k}\n")
        render_ts(out, result, ts, k, no_ts_result)
