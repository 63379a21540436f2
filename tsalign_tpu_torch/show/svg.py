"""SVG rendering of template-switch alignments.

Counterpart of lib_tsshow/src/svg.rs (create_ts_svg): the full
column-arrangement model (show/arrangement.py, mirroring
ts_arrangement.rs) rendered row by row — complement inners, complements,
inners, reference, query — with red curved jump arrows SP1->SP2 and
SP3->SP4 (svg/arrows.rs), switchpoint number labels, a legend, and the
optional no-TS arrangement below.  The reference embeds hand-digitized
vector fonts (svg/font.rs); this renderer uses standard SVG <text> with a
monospace font at a fixed advance so columns line up identically.

The renderer first builds a geometry-only plan (text runs + curves) that
show/png.py rasterizes with the same layout.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..result import AlignmentResult
from .arrangement import (
    BLANK,
    GAP,
    HID,
    SEP,
    SPACER,
    SRC,
    Cell,
    TsArrangement,
    arrangement_char_to_arrangement_column,
)

CW = 8.0  # character cell width
CH = 16.0  # row height
PAD = 10.0

COPY_COLORS = ["#00CC00", "#009900", "#006600", "#003300"]
OPTIONAL_COPY_COLORS = ["#88CC88", "#669966", "#446644", "#223322"]
OPTIONAL_SOURCE_COLOR = "blue"
COMPLEMENT_SOURCE_HIDDEN_COLOR = "grey"
LABEL_COLOR = "#555555"
ARROW_COLOR = "#CE2029"
TS_RUNNING_NUMBER = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"


@dataclass
class TextRun:
    x: float
    y: float
    text: str
    color: str = "black"
    scale: float = 1.0


@dataclass
class Curve:
    """Cubic bezier with an arrowhead at the end."""

    x0: float
    y0: float
    cx0: float
    cy0: float
    cx1: float
    cy1: float
    x1: float
    y1: float
    color: str = ARROW_COLOR


@dataclass
class RenderPlan:
    width: float
    height: float
    runs: List[TextRun] = field(default_factory=list)
    curves: List[Curve] = field(default_factory=list)


def _copy_color(copy_depth: Optional[int], optional: bool) -> str:
    if copy_depth is not None:
        pal = OPTIONAL_COPY_COLORS if optional else COPY_COLORS
        return pal[copy_depth % len(pal)]
    return OPTIONAL_SOURCE_COLOR if optional else "black"


def _render_source_cells(cells: List[Cell], seq: str) -> List[Tuple[str, str]]:
    out = []
    for c in cells:
        if c.kind == SRC:
            ch = seq[c.column] if 0 <= c.column < len(seq) else "?"
            out.append((ch.lower() if c.lower else ch, _copy_color(c.copy, False)))
        elif c.kind == GAP:
            out.append(("-", _copy_color(c.copy, False)))
        elif c.kind == SEP:
            out.append(("|", "black"))
        else:  # hidden / spacer / blank
            out.append((" ", "black"))
    return out


def _render_complement_cells(cells: List[Cell], comp_seq: str) -> List[Tuple[str, str]]:
    out = []
    for c in cells:
        if c.kind == SRC:
            ch = comp_seq[c.column] if 0 <= c.column < len(comp_seq) else "?"
            color = COMPLEMENT_SOURCE_HIDDEN_COLOR if c.source_hidden else "black"
            out.append((ch.lower() if c.lower else ch, color))
        elif c.kind == GAP:
            color = COMPLEMENT_SOURCE_HIDDEN_COLOR if c.source_hidden else "black"
            out.append(("-", color))
        else:
            out.append((" ", "black"))
    return out


def _render_inner_cells(cells: List[Cell], primary_seq: str) -> List[Tuple[str, str]]:
    out = []
    for c in cells:
        if c.kind == SRC:
            ch = primary_seq[c.column] if 0 <= c.column < len(primary_seq) else "?"
            out.append(
                (ch.lower() if c.lower else ch, _copy_color(c.copy, c.optional))
            )
        elif c.kind == GAP:
            out.append(("-", _copy_color(c.copy, False)))
        else:
            out.append((" ", "black"))
    return out


def _emit_row(
    plan: RenderPlan, x0: float, y: float, cells: List[Tuple[str, str]]
) -> None:
    """Append one row of cells as coalesced same-color text runs."""
    buf: List[str] = []
    start = 0
    color = None
    for i, (ch, col) in enumerate(cells):
        if col != color and any(c != " " for c in buf):
            plan.runs.append(
                TextRun(x0 + start * CW, y, "".join(buf), color or "black")
            )
            buf, start = [], i
        elif col != color:
            buf, start = [], i
        color = col
        buf.append(ch)
    if any(c != " " for c in buf):
        plan.runs.append(TextRun(x0 + start * CW, y, "".join(buf), color or "black"))


def build_plan(
    result: AlignmentResult,
    no_ts_result: Optional[AlignmentResult] = None,
    arrows: bool = True,
    context: Optional[int] = None,
    complements: bool = False,
    equal_cost_ranges: bool = False,
) -> RenderPlan:
    """Lay the alignment out as text runs + arrow curves (svg.rs:69-790)."""
    seqs = result.sequences
    reference, query = seqs.reference, seqs.query
    # Complement strings: reference_rc reversed = base-wise complement.
    reference_c = seqs.reference_rc[::-1]
    query_c = seqs.query_rc[::-1]

    arr = TsArrangement(
        result.reference_offset,
        result.query_offset,
        len(reference),
        len(query),
        result.alignment.iter_flat(),
        visualise_equal_cost_ranges=equal_cost_ranges,
    )
    if complements:
        arr.show_complete_complements_if_used()
    arr.remove_empty_columns()
    if context is not None:
        ref_range, qry_range = arr.limit_context_to(context)
    else:
        ref_range, qry_range = range(0, len(reference)), range(0, len(query))

    plan = RenderPlan(0.0, 0.0)

    # --- row stack (svg.rs:394-627) ---
    rows: List[Tuple[str, str, List[Tuple[str, str]]]] = []  # (key, label, cells)

    def primary_seq_of(inner) -> str:
        return reference if inner.template_switch.primary == "Reference" else query

    for i, inner in reversed(arr.reference_complement_inners()):
        label = f"TS-{TS_RUNNING_NUMBER[inner.template_switch.index]} inner:"
        rows.append((f"inner{i}", label, _render_inner_cells(inner.sequence, primary_seq_of(inner))))
    rows.append(("refc", "Reference complement:", _render_complement_cells(arr.reference_complement, reference_c)))
    for i, inner in reversed(arr.reference_inners()):
        label = f"TS-{TS_RUNNING_NUMBER[inner.template_switch.index]} inner:"
        rows.append((f"inner{i}", label, _render_inner_cells(inner.sequence, primary_seq_of(inner))))
    rows.append(("ref", "Reference:", _render_source_cells(arr.reference, reference)))
    rows.append(("qry", "Query:", _render_source_cells(arr.query, query)))
    for i, inner in arr.query_inners():
        label = f"TS-{TS_RUNNING_NUMBER[inner.template_switch.index]} inner:"
        rows.append((f"inner{i}", label, _render_inner_cells(inner.sequence, primary_seq_of(inner))))
    rows.append(("qryc", "Query complement:", _render_complement_cells(arr.query_complement, query_c)))
    for i, inner in arr.query_complement_inners():
        label = f"TS-{TS_RUNNING_NUMBER[inner.template_switch.index]} inner:"
        rows.append((f"inner{i}", label, _render_inner_cells(inner.sequence, primary_seq_of(inner))))

    label_w = (max((len(lbl) for _, lbl, _ in rows), default=10) + 1) * CW
    x0 = PAD + label_w
    row_y: Dict[str, float] = {}
    y = PAD + CH * 0.85
    for key, label, cells in rows:
        plan.runs.append(TextRun(PAD, y, label, LABEL_COLOR))
        _emit_row(plan, x0, y, cells)
        row_y[key] = y
        y += CH

    ts_height = y

    # --- switchpoint numbers + jump arrows (svg.rs:169-392) ---
    for i, inner in enumerate(arr.inners):
        ts = inner.template_switch
        running = TS_RUNNING_NUMBER[ts.index]
        primary_row_key = "ref" if ts.primary == "Reference" else "qry"
        primary_cells = arr.reference if ts.primary == "Reference" else arr.query
        sp1_char = ts.sp1_reference if ts.primary == "Reference" else ts.sp1_query
        sp4_char = ts.sp4_reference if ts.primary == "Reference" else ts.sp4_query
        try:
            sp1_col = arrangement_char_to_arrangement_column(primary_cells, sp1_char)
        except IndexError:
            sp1_col = len(primary_cells)
        try:
            sp4_col = arrangement_char_to_arrangement_column(primary_cells, sp4_char)
        except IndexError:
            sp4_col = len(primary_cells)
        # Advance SP4 past blanks (svg.rs:251-284 first non-blank).
        while sp4_col < len(primary_cells) and primary_cells[sp4_col].is_blank():
            sp4_col += 1

        sec_first = arr.inner_first_non_blank_column(i)
        sec_last = arr.inner_last_non_blank_column(i) + 1
        forward = not inner.complement
        inner_key = f"inner{i}"
        py = row_y.get(primary_row_key, PAD)
        iy = row_y.get(inner_key, PAD)

        num_scale = 0.5
        num_w = 2 * CW * num_scale

        def num(label: str, col: int, yy: float, align_left: bool):
            x = x0 + col * CW
            if align_left:
                x -= num_w
            plan.runs.append(TextRun(x, yy - CH * 0.35, label, "black", num_scale))

        num(f"{running}1", sp1_col, py, True)
        num(f"{running}2", sec_first if forward else sec_last, iy, not forward)
        num(f"{running}3", sec_last if forward else sec_first, iy, forward)
        num(f"{running}4", sp4_col, py, False)

        if arrows:
            ycur_p = py - CH * 0.3
            ycur_i = iy - CH * 0.3
            # SP1 -> SP2
            fx = x0 + sp1_col * CW + num_w
            tx = x0 + (sec_first if forward else sec_last) * CW + (
                -num_w if forward else num_w
            )
            d = max(abs(fx - tx) * 0.1, 2 * CW)
            plan.curves.append(
                Curve(fx, ycur_p, fx + d, ycur_p, tx + (-d if forward else d), ycur_i, tx, ycur_i)
            )
            # SP3 -> SP4
            fx = x0 + (sec_last if forward else sec_first) * CW + (
                num_w if forward else -num_w
            )
            tx = x0 + sp4_col * CW - num_w
            d = max(abs(fx - tx) * 0.1, 2 * CW)
            plan.curves.append(
                Curve(fx, ycur_i, fx + (d if forward else -d), ycur_i, tx - d, ycur_p, tx, ycur_p)
            )

    width = x0 + arr.width() * CW + PAD
    y = ts_height

    # --- no-TS arrangement below (svg.rs:656-733) ---
    if no_ts_result is not None and no_ts_result.has_target:
        nseqs = no_ts_result.sequences
        narr = TsArrangement(
            no_ts_result.reference_offset,
            no_ts_result.query_offset,
            len(nseqs.reference),
            len(nseqs.query),
            no_ts_result.alignment.iter_flat(),
        )
        # Clip to the context of the TS arrangement.
        lo = min(
            narr._src_to_arr(narr.reference, ref_range.start),
            narr._src_to_arr(narr.query, qry_range.start),
        )
        hi = max(
            narr._src_to_arr(narr.reference, min(ref_range.stop, len(nseqs.reference))),
            narr._src_to_arr(narr.query, min(qry_range.stop, len(nseqs.query))),
        )
        narr.remove_column_range(hi, narr.width())
        narr.remove_column_range(0, lo)

        y += CH  # vertical spacer
        for label, cells in (
            ("Reference:", _render_source_cells(narr.reference, nseqs.reference)),
            ("Query:", _render_source_cells(narr.query, nseqs.query)),
        ):
            plan.runs.append(TextRun(PAD, y, label, LABEL_COLOR))
            _emit_row(plan, x0, y, cells)
            y += CH
        width = max(width, x0 + narr.width() * CW + PAD)

    # --- legend (svg.rs:917-1041) ---
    y += CH
    scale = 0.6
    legend = [
        ("Legend:", "black"),
        (f"Reference  {seqs.reference_name}", "black"),
        (f"Query      {seqs.query_name}", "black"),
        ("GREEN CHARACTERS  Repeated characters due to a TS with SP4 < SP1", COPY_COLORS[0]),
        ("BLUE CHARACTERS   Equal-cost range of the TSM", OPTIONAL_SOURCE_COLOR),
    ]
    for text, color in legend:
        plan.runs.append(TextRun(PAD, y, text, color, scale))
        y += CH * scale
        width = max(width, PAD + len(text) * CW * scale + PAD)

    plan.width = width
    plan.height = y + PAD
    return plan


def _esc(s: str) -> str:
    return s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")


def plan_to_svg(plan: RenderPlan) -> str:
    out = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{plan.width:.0f}" '
        f'height="{plan.height:.0f}" viewBox="0 0 {plan.width:.0f} {plan.height:.0f}">',
        "<defs>"
        '<marker id="arrow_head_red" viewBox="0 0 10 10" orient="auto-start-reverse" '
        'markerWidth="10" markerHeight="10" refX="10" refY="5">'
        f'<path d="M 1 1 L 10 5 L 1 9" fill="none" stroke="{ARROW_COLOR}"/></marker>'
        "</defs>",
        f'<rect width="{plan.width:.0f}" height="{plan.height:.0f}" fill="white"/>',
        "<style>text { font-family: \"DejaVu Sans Mono\", monospace; "
        "font-size: 13px; white-space: pre; }</style>",
    ]
    for r in plan.runs:
        size = "" if r.scale == 1.0 else f' font-size="{13 * r.scale:.1f}px"'
        tl = f' textLength="{len(r.text) * CW * r.scale:.1f}"' if len(r.text) > 1 else ""
        out.append(
            f'<text x="{r.x:.1f}" y="{r.y:.1f}" fill="{r.color}"{size}{tl} '
            f'xml:space="preserve">{_esc(r.text)}</text>'
        )
    for c in plan.curves:
        out.append(
            f'<path d="M {c.x0:.1f},{c.y0:.1f} C {c.cx0:.1f},{c.cy0:.1f} '
            f'{c.cx1:.1f},{c.cy1:.1f} {c.x1:.1f},{c.y1:.1f}" stroke="{c.color}" '
            f'stroke-width="1.2" fill="none" marker-end="url(#arrow_head_red)"/>'
        )
    out.append("</svg>")
    return "\n".join(out)


def create_ts_svg(
    result: AlignmentResult,
    no_ts_result: Optional[AlignmentResult] = None,
    arrows: bool = True,
    context: Optional[int] = None,
    complements: bool = False,
    equal_cost_ranges: bool = False,
) -> str:
    """Render the alignment as an SVG document string
    (lib_tsshow/src/svg.rs:69 create_ts_svg counterpart).

    complements: unhide whole complement rows when any part is used
    (show.rs -c); equal_cost_ranges: render optional (blue / light green)
    inner characters marking how far switchpoints can shift at equal cost
    (show.rs -e)."""
    if not result.has_target:
        return create_error_svg("alignment has no target")
    plan = build_plan(
        result,
        no_ts_result,
        arrows=arrows,
        context=context,
        complements=complements,
        equal_cost_ranges=equal_cost_ranges,
    )
    return plan_to_svg(plan)


def create_error_svg(message: str) -> str:
    """svg.rs:1043 create_error_svg counterpart."""
    return (
        '<svg xmlns="http://www.w3.org/2000/svg" width="640" height="60" '
        'viewBox="0 0 640 60">'
        '<rect width="640" height="60" fill="white"/>'
        f'<text x="16" y="35" font-family="sans-serif">{_esc(message)}</text></svg>'
    )
