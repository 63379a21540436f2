"""Column-arrangement model of a template-switch alignment.

Behavioral counterpart of lib_tsshow/src/ts_arrangement.rs (+ source.rs,
complement.rs, inner.rs, template_switch.rs): lays the reference and query
out in shared arrangement columns, hides each TSM's primary inner stretch,
inserts duplicate characters for negative anti-primary gaps, builds
complement rows (hidden until a reverse TSM reads them) and one inner row
per TSM aligned column-exactly against its (complemented) ancestor.

All rows share one column axis, so renderers (SVG, PNG, text) can draw
glyphs at ``column * char_width`` and everything lines up like the
reference's output.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from ..alignment import (
    Alignment,
    TemplateSwitchEntrance,
    TemplateSwitchExit,
)

# Cell kinds shared by the three row families.
SRC = "src"  # a real sequence character (column = source index)
HID = "hid"  # a hidden character (TSM inner stretch in the primary row)
GAP = "gap"  # an alignment gap '-'
SEP = "sep"  # '|' separating aligned from unaligned sequence parts
SPACER = "spacer"  # like blank, but keeps its column alive
BLANK = "blank"


class Cell:
    """One arrangement cell (SourceChar / ComplementChar / InnerChar
    equivalent - ts_arrangement/character.rs)."""

    __slots__ = ("kind", "column", "lower", "copy", "source_hidden", "optional")

    def __init__(
        self,
        kind: str,
        column: int = -1,
        lower: bool = False,
        copy: Optional[int] = None,
        source_hidden: bool = False,
        optional: bool = False,
    ):
        self.kind = kind
        self.column = column
        self.lower = lower
        self.copy = copy  # copy depth; None = not a copy
        self.source_hidden = source_hidden
        self.optional = optional

    # --- predicates (character.rs Char trait) ---
    def is_char(self) -> bool:
        return self.kind in (SRC, HID)

    def is_gap(self) -> bool:
        return self.kind == GAP

    def is_blank(self) -> bool:
        return self.kind == BLANK

    def is_hidden(self) -> bool:
        return self.kind == HID

    def is_blank_or_hidden(self) -> bool:
        return self.kind in (BLANK, HID)

    def is_source_char(self) -> bool:
        """A real (non-copy) sequence character."""
        return self.is_char() and self.copy is None

    def is_gap_or_blank(self) -> bool:
        return self.kind in (GAP, BLANK)

    def clone(self) -> "Cell":
        return Cell(
            self.kind, self.column, self.lower, self.copy,
            self.source_hidden, self.optional,
        )

    def make_visible_copy(self) -> "Cell":
        depth = 0 if self.copy is None else self.copy + 1
        return Cell(SRC, self.column, False, depth)

    def __repr__(self):  # debugging aid
        return f"Cell({self.kind},{self.column}{'~' if self.lower else ''})"


def _src_cells(n: int) -> List[Cell]:
    return [Cell(SRC, i) for i in range(n)]


# ---------------------------------------------------------------------------
# helpers over a row (TaggedVec<ArrangementColumn, _> equivalents)

def source_to_arrangement_column(seq: List[Cell], source_column: int) -> Optional[int]:
    """Arrangement column of the char with this source index
    (source.rs try_source_to_arrangement_column); ``source_column`` one past
    the last char maps to ``len(seq)``."""
    best = None
    for i, c in enumerate(seq):
        if c.is_char():
            if c.column == source_column:
                return i
            if c.column + 1 == source_column and best is None:
                best = len(seq)
    return best


def arrangement_to_arrangement_char_column(seq: List[Cell], col: int) -> int:
    """Count of chars before this arrangement column (source.rs)."""
    return sum(1 for c in seq[:col] if c.is_char())


def arrangement_char_to_arrangement_column(seq: List[Cell], char_col: int) -> int:
    """Arrangement column of the char_col-th char; len(seq) when one past."""
    k = 0
    for i, c in enumerate(seq):
        if c.is_char():
            if k == char_col:
                return i
            k += 1
    if k == char_col:
        return len(seq)
    raise IndexError(f"char column {char_col} out of range ({k} chars)")


def arrangement_to_source_column(seq: List[Cell], col: int) -> Optional[int]:
    """Count of real source chars before this arrangement column."""
    if col >= len(seq):
        return None
    return sum(1 for c in seq[:col] if c.is_source_char())


def arrangement_char_to_source_column(seq: List[Cell], char_col: int) -> int:
    """Source index of the char_col-th char."""
    k = 0
    for c in seq:
        if c.is_char():
            if k == char_col:
                return c.column
            k += 1
    raise IndexError(f"char column {char_col} out of range")


def _count_copy_chars_before_next_real_char(seq: List[Cell], offset: int) -> int:
    n = 0
    for c in seq[offset:]:
        if c.is_source_char():
            break
        if c.is_char() and c.copy is not None:
            n += 1
    return n


def _remove_multi(seq: List[Cell], columns: List[int]) -> None:
    drop = set(columns)
    seq[:] = [c for i, c in enumerate(seq) if i not in drop]


# ---------------------------------------------------------------------------


@dataclass
class TemplateSwitchRecord:
    """Per-TSM bookkeeping (ts_arrangement/template_switch.rs)."""

    index: int
    primary: str  # "Reference" | "Query"
    secondary: str  # "Reference" | "Query"
    sp1_reference: int  # arrangement *char* columns
    sp1_query: int
    sp4_reference: int = 0
    sp4_query: int = 0
    sp2_secondary: int = 0  # *source* columns on the secondary sequence
    sp3_secondary: int = 0
    inner: List[Cell] = field(default_factory=list)
    inner_alignment: List[str] = field(default_factory=list)
    equal_cost_range: object = None

    def remove_hidden_chars(self, removed_ref: List[int], removed_qry: List[int]):
        self.sp1_reference -= sum(1 for c in removed_ref if c < self.sp1_reference)
        self.sp4_reference -= sum(1 for c in removed_ref if c < self.sp4_reference)
        self.sp1_query -= sum(1 for c in removed_qry if c < self.sp1_query)
        self.sp4_query -= sum(1 for c in removed_qry if c < self.sp4_query)


class SourceArrangement:
    """Reference/query rows with gaps, hidden TSM inners, duplicate
    characters and spacers (ts_arrangement/source.rs TsSourceArrangement)."""

    def __init__(
        self,
        reference_offset: int,
        query_offset: int,
        reference_length: int,
        query_length: int,
        ops: Iterable,
        template_switches_out: List[TemplateSwitchRecord],
    ):
        ref_left = max(0, query_offset - reference_offset)
        qry_left = max(0, reference_offset - query_offset)
        self.reference: List[Cell] = [Cell(BLANK) for _ in range(ref_left)] + _src_cells(reference_length)
        self.query: List[Cell] = [Cell(BLANK) for _ in range(qry_left)] + _src_cells(query_length)
        self.reference_length = reference_length
        self.query_length = query_length

        cur_r = ref_left + reference_offset
        cur_q = qry_left + query_offset
        if reference_offset > 0 or query_offset > 0:
            self.reference.insert(cur_r, Cell(SEP))
            cur_r += 1
            self.query.insert(cur_q, Cell(SEP))
            cur_q += 1

        ts_index = 0
        it = iter(ops)
        for t in it:
            if isinstance(t, TemplateSwitchEntrance):
                ts, cur_r, cur_q = self._align_ts(ts_index, t, it, cur_r, cur_q)
                template_switches_out.append(ts)
                ts_index += 1
                continue
            if not isinstance(t, str):
                raise ValueError(f"unexpected op {t!r} outside a TSM")
            if t in ("PrimaryInsertion", "PrimaryFlankInsertion"):
                self.reference.insert(
                    cur_r, Cell(GAP, copy=self.query[cur_q].copy if self.query[cur_q].is_char() or self.query[cur_q].is_gap() else None)
                )
                cur_r += 1
                cur_q += 1
            elif t in ("PrimaryDeletion", "PrimaryFlankDeletion"):
                self.query.insert(
                    cur_q, Cell(GAP, copy=self.reference[cur_r].copy if self.reference[cur_r].is_char() or self.reference[cur_r].is_gap() else None)
                )
                cur_r += 1
                cur_q += 1
            elif t in ("PrimarySubstitution", "PrimaryFlankSubstitution"):
                self.reference[cur_r].lower = True
                self.query[cur_q].lower = True
                cur_r += 1
                cur_q += 1
            elif t in ("PrimaryMatch", "PrimaryFlankMatch"):
                cur_r += 1
                cur_q += 1
            elif t in ("Root", "PrimaryReentry"):
                pass
            else:
                raise ValueError(f"unexpected op {t!r} outside a TSM")

        # Separator if sequence continues right of the alignment.
        r_src = arrangement_to_source_column(self.reference, cur_r)
        q_src = arrangement_to_source_column(self.query, cur_q)
        if (r_src is not None and r_src < reference_length - 1) or (
            q_src is not None and q_src < query_length - 1
        ):
            self.reference.insert(cur_r, Cell(SEP))
            self.query.insert(cur_q, Cell(SEP))

        while len(self.reference) < len(self.query):
            self.reference.append(Cell(BLANK))
        while len(self.query) < len(self.reference):
            self.query.append(Cell(BLANK))

    # -- per-TSM arrangement (source.rs align_ts) --
    def _align_ts(self, ts_index: int, entrance: TemplateSwitchEntrance, ops, cur_r: int, cur_q: int):
        sp1_reference = arrangement_to_arrangement_char_column(self.reference, cur_r)
        sp1_query = arrangement_to_arrangement_char_column(self.query, cur_q)

        if entrance.secondary == "Reference":
            base = arrangement_to_source_column(self.reference, cur_r)
            base -= _count_copy_chars_before_next_real_char(self.reference, cur_r)
        else:
            base = arrangement_to_source_column(self.query, cur_q)
            base -= _count_copy_chars_before_next_real_char(self.query, cur_q)
        sp2_secondary = base + entrance.first_offset

        sp3_secondary = sp2_secondary
        step = 1 if entrance.direction == "Forward" else -1
        primary_inner_length = 0
        inner_alignment: List[str] = []
        anti_primary_gap = None
        for t in ops:
            if isinstance(t, TemplateSwitchExit):
                anti_primary_gap = t.anti_primary_gap
                break
            if t == "SecondaryDeletion":
                sp3_secondary += step
                inner_alignment.append(t)
            elif t in ("SecondarySubstitution", "SecondaryMatch"):
                sp3_secondary += step
                primary_inner_length += 1
                inner_alignment.append(t)
            elif t == "SecondaryInsertion":
                primary_inner_length += 1
                inner_alignment.append(t)
            elif t == "SecondaryRoot":
                pass
            else:
                raise ValueError(f"unexpected op {t!r} inside a TSM")
        if anti_primary_gap is None:
            raise ValueError("TSM without exit")

        if entrance.primary == "Reference":
            primary, anti = self.reference, self.query
            cur_p, cur_ap = cur_r, cur_q
        else:
            primary, anti = self.query, self.reference
            cur_p, cur_ap = cur_q, cur_r

        # Hide the inner stretch in the primary row, keeping visible copies.
        inner: List[Cell] = []
        k, i = 0, cur_p
        while k < primary_inner_length:
            c = primary[i]
            if c.is_char():
                inner.append(c.clone())
                c.kind = HID
                c.lower = False
                k += 1
            else:
                # (the reference assumes a contiguous char run here)
                inner.append(c.clone())
                k += 1
            i += 1
        cur_p += primary_inner_length

        if anti_primary_gap < 0:
            dup = []
            for c in reversed(anti[:cur_ap]):
                if c.is_char():
                    dup.append(c.make_visible_copy())
                    if len(dup) == -anti_primary_gap:
                        break
            anti[cur_ap:cur_ap] = list(reversed(dup))
            anti_len = 0
        else:
            cur_ap += anti_primary_gap
            anti_len = anti_primary_gap

        required_spacers = max(0, 4 - anti_len)
        if primary_inner_length < anti_len:
            delta = anti_len - primary_inner_length
            primary[cur_p:cur_p] = [Cell(BLANK) for _ in range(delta)]
            cur_p += delta
        elif primary_inner_length > anti_len:
            delta = primary_inner_length - anti_len
            fill = [Cell(SPACER) for _ in range(min(required_spacers, delta))]
            fill += [Cell(BLANK) for _ in range(delta - len(fill))]
            anti[cur_ap:cur_ap] = fill
            required_spacers = max(0, required_spacers - delta)
            cur_ap += delta

        primary[cur_p:cur_p] = [Cell(BLANK) for _ in range(required_spacers)]
        anti[cur_ap:cur_ap] = [Cell(SPACER) for _ in range(required_spacers)]
        cur_p += required_spacers
        cur_ap += required_spacers

        if entrance.primary == "Reference":
            cur_r, cur_q = cur_p, cur_ap
        else:
            cur_r, cur_q = cur_ap, cur_p

        ts = TemplateSwitchRecord(
            index=ts_index,
            primary=entrance.primary,
            secondary=entrance.secondary,
            sp1_reference=sp1_reference,
            sp1_query=sp1_query,
            sp4_reference=arrangement_to_arrangement_char_column(self.reference, cur_r),
            sp4_query=arrangement_to_arrangement_char_column(self.query, cur_q),
            sp2_secondary=sp2_secondary,
            sp3_secondary=sp3_secondary,
            inner=inner,
            inner_alignment=inner_alignment,
            equal_cost_range=entrance.equal_cost_range,
        )
        return ts, cur_r, cur_q

    # -- row ops used by the inner arrangement --
    def secondary(self, secondary: str) -> List[Cell]:
        return self.reference if secondary == "Reference" else self.query

    def insert_secondary_gap(self, secondary: str, col: int) -> None:
        seq = self.secondary(secondary)
        if col == 0:
            depth = seq[col].copy if col < len(seq) and (seq[col].is_char() or seq[col].is_gap()) else None
        elif col >= len(seq):
            depth = seq[-1].copy if (seq[-1].is_char() or seq[-1].is_gap()) else None
        else:
            d1 = seq[col - 1].copy if (seq[col - 1].is_char() or seq[col - 1].is_gap()) else None
            d2 = seq[col].copy if (seq[col].is_char() or seq[col].is_gap()) else None
            depth = min(d1, d2) if d1 is not None and d2 is not None else None
        if secondary == "Reference":
            self.reference.insert(col, Cell(GAP, copy=depth))
            self.query.insert(col, Cell(BLANK))
        else:
            self.reference.insert(col, Cell(BLANK))
            self.query.insert(col, Cell(GAP, copy=depth))

    def insert_blank(self, col: int) -> None:
        self.reference.insert(col, Cell(BLANK))
        self.query.insert(col, Cell(BLANK))

    def width(self) -> int:
        return len(self.reference)

    def remove_columns(self, columns: List[int]) -> Tuple[List[int], List[int]]:
        """Remove arrangement columns; returns the removed chars as
        arrangement *char* columns per row (RemovedHiddenChars)."""
        removed_ref = [
            arrangement_to_arrangement_char_column(self.reference, c)
            for c in columns
            if self.reference[c].is_char()
        ]
        removed_qry = [
            arrangement_to_arrangement_char_column(self.query, c)
            for c in columns
            if self.query[c].is_char()
        ]
        _remove_multi(self.reference, columns)
        _remove_multi(self.query, columns)
        return removed_ref, removed_qry


class ComplementArrangement:
    """Complement rows, hidden until shown (complement.rs)."""

    def __init__(self, source: SourceArrangement):
        self.reference_c: List[Cell] = []
        self.query_c: List[Cell] = []
        for seq, out in ((source.reference, self.reference_c), (source.query, self.query_c)):
            for c in seq:
                if c.is_char() and c.copy is None:
                    out.append(Cell(HID, c.column, source_hidden=c.is_hidden()))
                else:
                    out.append(Cell(BLANK))

    def secondary_complement(self, secondary: str) -> List[Cell]:
        return self.reference_c if secondary == "Reference" else self.query_c

    def show(self, secondary: str, col: int) -> None:
        c = self.secondary_complement(secondary)[col]
        if c.kind == HID:
            c.kind = SRC

    def to_lower(self, secondary: str, col: int) -> None:
        self.secondary_complement(secondary)[col].lower = True

    def insert_gap(self, secondary: str, col: int) -> None:
        seq = self.secondary_complement(secondary)

        def hidden_of(cells):
            for c in cells:
                if c.kind != BLANK:
                    return c.source_hidden
            return True

        source_hidden = hidden_of(seq[col:]) and hidden_of(reversed(seq[:col]))
        if secondary == "Reference":
            self.reference_c.insert(col, Cell(GAP, source_hidden=source_hidden))
            self.query_c.insert(col, Cell(BLANK))
        else:
            self.reference_c.insert(col, Cell(BLANK))
            self.query_c.insert(col, Cell(GAP, source_hidden=source_hidden))

    def insert_blank(self, col: int) -> None:
        self.reference_c.insert(col, Cell(BLANK))
        self.query_c.insert(col, Cell(BLANK))

    def width(self) -> int:
        return len(self.reference_c)

    def remove_columns(self, columns: List[int]) -> None:
        _remove_multi(self.reference_c, columns)
        _remove_multi(self.query_c, columns)


class Inner:
    """One TSM's inner row (inner.rs TsInner)."""

    def __init__(self, sequence: List[Cell], ts: TemplateSwitchRecord, reference: bool, complement: bool):
        self.sequence = sequence
        self.template_switch = ts
        self.reference = reference
        self.complement = complement


class TsArrangement:
    """The full arrangement (ts_arrangement.rs TsArrangement)."""

    def __init__(
        self,
        reference_offset: int,
        query_offset: int,
        reference_length: int,
        query_length: int,
        ops: Iterable,
        visualise_equal_cost_ranges: bool = False,
    ):
        switches: List[TemplateSwitchRecord] = []
        self.source = SourceArrangement(
            reference_offset, query_offset, reference_length, query_length, ops, switches
        )
        self.complement = ComplementArrangement(self.source)
        self.inners: List[Inner] = []
        for ts in switches:
            self._arrange_inner(ts, visualise_equal_cost_ranges)

    # -- inner row construction (inner.rs TsInnerArrangement::new) --
    def _arrange_inner(self, ts: TemplateSwitchRecord, visualise_ecr: bool) -> None:
        src = self.source
        comp = self.complement
        sec = ts.secondary
        width = src.width()

        def sec_src_to_arr(source_col: int) -> int:
            col = source_to_arrangement_column(src.secondary(sec), source_col)
            return col if col is not None else len(src.secondary(sec))

        sp2 = sec_src_to_arr(ts.sp2_secondary)
        sp3 = sec_src_to_arr(ts.sp3_secondary)
        forward = sp2 < sp3

        source_inner = list(ts.inner)
        inner: List[Cell] = [Cell(BLANK) for _ in range(min(sp2, sp3))]
        col = min(sp2, sp3)

        def from_source(c: Cell) -> Cell:
            if c.is_char():
                return Cell(SRC, c.column, c.lower, c.copy)
            if c.is_gap():
                return Cell(GAP, copy=c.copy)
            return Cell(BLANK)

        if forward:
            idx = 0
            for t in ts.inner_alignment:
                if t == "SecondaryInsertion":
                    sec_row = src.secondary(sec)
                    is_gap = False
                    while col < len(sec_row):
                        c = sec_row[col]
                        if c.is_gap() or c.is_source_char():
                            is_gap = c.is_gap()
                            break
                        inner.append(Cell(BLANK))
                        col += 1
                    if not is_gap:
                        src.insert_secondary_gap(sec, col)
                        comp.insert_blank(col)
                        for ex in self.inners:
                            ex.sequence.insert(col, Cell(BLANK))
                        sp3 += 1
                    inner.append(from_source(source_inner[idx]))
                    idx += 1
                    col += 1
                elif t == "SecondaryDeletion":
                    sec_row = src.secondary(sec)
                    while not sec_row[col].is_source_char():
                        inner.append(Cell(BLANK))
                        col += 1
                    inner.append(Cell(GAP, copy=sec_row[col].copy))
                    col += 1
                else:  # Sub / Match
                    sec_row = src.secondary(sec)
                    while not sec_row[col].is_source_char():
                        inner.append(Cell(BLANK))
                        col += 1
                    cell = from_source(source_inner[idx])
                    idx += 1
                    if t == "SecondarySubstitution":
                        sec_row[col].lower = True
                        cell.lower = True
                    inner.append(cell)
                    col += 1
        else:
            idx = len(source_inner) - 1
            for t in reversed(ts.inner_alignment):
                if t == "SecondaryInsertion":
                    c_row = comp.secondary_complement(sec)
                    is_gap = False
                    while col < len(c_row):
                        c = c_row[col]
                        if c.is_gap() or c.is_char():
                            is_gap = c.is_gap()
                            break
                        inner.append(Cell(BLANK))
                        col += 1
                    if not is_gap:
                        comp.insert_gap(sec, col)
                        src.insert_blank(col)
                        for ex in self.inners:
                            ex.sequence.insert(col, Cell(BLANK))
                        sp2 += 1
                    inner.append(from_source(source_inner[idx]))
                    idx -= 1
                    col += 1
                elif t == "SecondaryDeletion":
                    c_row = comp.secondary_complement(sec)
                    while not c_row[col].is_char():
                        inner.append(Cell(BLANK))
                        col += 1
                    comp.show(sec, col)
                    inner.append(Cell(GAP, copy=src.secondary(sec)[col].copy))
                    col += 1
                else:  # Sub / Match
                    sec_row = src.secondary(sec)
                    while not sec_row[col].is_source_char():
                        inner.append(Cell(BLANK))
                        col += 1
                    comp.show(sec, col)
                    cell = from_source(source_inner[idx])
                    idx -= 1
                    if t == "SecondarySubstitution":
                        comp.to_lower(sec, col)
                        cell.lower = True
                    inner.append(cell)
                    col += 1

        while len(inner) < src.width():
            inner.append(Cell(BLANK))
        del inner[src.width():]

        if visualise_ecr and not forward and ts.equal_cost_range is not None:
            self._visualise_ecr(inner, ts)

        self.inners.append(
            Inner(inner, ts, reference=(sec == "Reference"), complement=not forward)
        )

    @staticmethod
    def _visualise_ecr(inner: List[Cell], ts: TemplateSwitchRecord) -> None:
        """Equal-cost-range characters for reverse TSMs (inner.rs:322-414)."""
        ecr = ts.equal_cost_range
        if ecr is None or not getattr(ecr, "is_valid", lambda: False)():
            return
        non_blank = [i for i, c in enumerate(inner) if not c.is_blank()]
        if not non_blank:
            return
        first_non_blank = non_blank[0]
        last_non_blank = non_blank[-1]
        first_final_blank = last_non_blank + 1
        chars = [i for i, c in enumerate(inner) if c.is_source_char()]
        if not chars:
            return
        first_source_column = inner[chars[0]].column
        last_source_column = inner[chars[-1]].column

        # Prefix extension to max_end.
        col, s = first_non_blank, first_source_column
        for _ in range(max(0, ecr.max_end)):
            col -= 1
            s += 1
            if col < 0:
                break
            inner[col] = Cell(SRC, s, optional=True)
        # Suffix extension to min_start.
        col, s = first_final_blank - 1, last_source_column
        for _ in range(max(0, -ecr.min_start)):
            col += 1
            s -= 1
            if col >= len(inner):
                break
            inner[col] = Cell(SRC, s, optional=True)
        # Convert prefix chars to optional up to min_end.
        col = first_non_blank
        for _ in range(max(0, -ecr.min_end)):
            while col < len(inner) and not inner[col].is_source_char():
                col += 1
            if col >= len(inner):
                break
            inner[col].optional = True
            col += 1
        # Convert suffix chars to optional up to max_start.
        col = first_final_blank
        for _ in range(max(0, ecr.max_start)):
            col -= 1
            while col >= 0 and not inner[col].is_source_char():
                col -= 1
            if col < 0:
                break
            inner[col].optional = True

    # ------------------------------------------------------------------
    def width(self) -> int:
        return self.source.width()

    @property
    def reference(self) -> List[Cell]:
        return self.source.reference

    @property
    def query(self) -> List[Cell]:
        return self.source.query

    @property
    def reference_complement(self) -> List[Cell]:
        return self.complement.reference_c

    @property
    def query_complement(self) -> List[Cell]:
        return self.complement.query_c

    def template_switches(self) -> List[TemplateSwitchRecord]:
        return [inner.template_switch for inner in self.inners]

    def reference_inners(self) -> List[Tuple[int, Inner]]:
        return [(i, x) for i, x in enumerate(self.inners) if x.reference and not x.complement]

    def query_inners(self) -> List[Tuple[int, Inner]]:
        return [(i, x) for i, x in enumerate(self.inners) if not x.reference and not x.complement]

    def reference_complement_inners(self) -> List[Tuple[int, Inner]]:
        return [(i, x) for i, x in enumerate(self.inners) if x.reference and x.complement]

    def query_complement_inners(self) -> List[Tuple[int, Inner]]:
        return [(i, x) for i, x in enumerate(self.inners) if not x.reference and x.complement]

    def show_complete_complements_if_used(self) -> None:
        for seq in (self.complement.reference_c, self.complement.query_c):
            if any(c.kind == SRC for c in seq):
                for c in seq:
                    if c.kind == HID:
                        c.kind = SRC

    def remove_empty_columns(self) -> None:
        rows = [
            self.source.reference,
            self.source.query,
            self.complement.reference_c,
            self.complement.query_c,
        ] + [x.sequence for x in self.inners]
        remove = [
            i
            for i in range(self.width())
            if all(r[i].is_blank_or_hidden() for r in rows)
        ]
        self._remove_columns(remove)

    def _remove_columns(self, columns: List[int]) -> None:
        removed_ref, removed_qry = self.source.remove_columns(columns)
        self.complement.remove_columns(columns)
        for x in self.inners:
            _remove_multi(x.sequence, columns)
            x.template_switch.remove_hidden_chars(removed_ref, removed_qry)

    def remove_column_range(self, start: int, end: int) -> None:
        self._remove_columns(list(range(max(0, start), min(end, self.width()))))

    # -- context limiting (ts_arrangement.rs limit_context_to) --
    def _char_to_source(self, seq: List[Cell], char_col: int) -> int:
        n = self._nchars(seq)
        if n == 0:
            return 0
        return arrangement_char_to_source_column(seq, min(char_col, n - 1))

    def first_interesting_column(self) -> int:
        vals = []
        for x in self.inners:
            ts = x.template_switch
            cand = [
                self._char_to_source(self.reference, ts.sp1_reference),
                self._char_to_source(self.query, ts.sp1_query),
                ts.sp2_secondary,
                ts.sp3_secondary,
                self._char_to_source(self.reference, ts.sp4_reference),
                self._char_to_source(self.query, ts.sp4_query),
            ]
            for c in x.sequence:
                if not c.is_gap_or_blank() and c.is_char():
                    cand.append(c.column)
                    break
            vals.append(min(cand))
        return min(vals) if vals else 0

    def last_interesting_column(self) -> int:
        vals = []
        for x in self.inners:
            ts = x.template_switch
            cand = [
                max(0, self._char_to_source(self.reference, ts.sp1_reference) - 1),
                max(0, self._char_to_source(self.query, ts.sp1_query) - 1),
                max(0, ts.sp2_secondary - 1),
                max(0, ts.sp3_secondary - 1),
                max(0, self._char_to_source(self.reference, ts.sp4_reference) - 1),
                max(0, self._char_to_source(self.query, ts.sp4_query) - 1),
            ]
            for c in reversed(x.sequence):
                if not c.is_gap_or_blank() and c.is_char():
                    cand.append(c.column)
                    break
            vals.append(max(cand))
        if vals:
            return max(vals)
        return max(self.source.reference_length, self.source.query_length)

    @staticmethod
    def _nchars(seq: List[Cell]) -> int:
        return sum(1 for c in seq if c.is_char())

    def limit_context_to(self, context: int) -> Tuple[range, range]:
        first = max(0, self.first_interesting_column() - context)
        last = self.last_interesting_column() + 1 + context
        res = (
            range(first, min(last, self.source.reference_length)),
            range(first, min(last, self.source.query_length)),
        )
        first_arr = min(
            self._src_to_arr(self.reference, first),
            self._src_to_arr(self.query, first),
        )
        last_arr = max(
            self._src_to_arr(self.reference, min(last, self.source.reference_length)),
            self._src_to_arr(self.query, min(last, self.source.query_length)),
        )
        self.remove_column_range(last_arr, self.width())
        self.remove_column_range(0, first_arr)
        return res

    def _src_to_arr(self, seq: List[Cell], source_col: int) -> int:
        col = source_to_arrangement_column(seq, source_col)
        return col if col is not None else len(seq)

    def inner_first_non_blank_column(self, idx: int) -> int:
        seq = self.inners[idx].sequence
        for i, c in enumerate(seq):
            if not c.is_blank():
                return i
        return len(seq)

    def inner_last_non_blank_column(self, idx: int) -> int:
        seq = self.inners[idx].sequence
        for i in range(len(seq) - 1, -1, -1):
            if not seq[i].is_blank():
                return i
        return 0
