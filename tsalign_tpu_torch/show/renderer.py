"""Column-aligned multi-row alignment renderer.

Behavioral counterpart of the reference's `MultipairAlignmentRenderer`
(lib_tsshow/src/plain_text/mutlipair_alignment_renderer.rs): rows of
characters share one global column space; adding a sequence aligned against
an existing row walks the alignment ops, reusing the base row's gap columns
and inserting fresh gap columns (into every row) where the new sequence has
an insertion relative to the base.  Cells are Blank (outside the row's
extent, rendered as spaces), Gap ('-') or a character.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, TextIO, Tuple

BLANK = None  # rendered as ' '
GAP = "-"


def op_consumes(t: str) -> Tuple[bool, bool]:
    """(consumes_reference_like, consumes_query_like) for a flat op name.

    Primary ops: Deletion consumes reference, Insertion consumes query.
    Secondary ops (the 2-3 alignment of primary vs secondary): Deletion
    consumes the secondary, Insertion consumes the primary — mapped here as
    (first, second) = (primary, secondary) so callers pick the roles.
    """
    if t.endswith(("Match", "Substitution")):
        return True, True
    if t.endswith("Deletion"):
        return True, False
    if t.endswith("Insertion"):
        return False, True
    if t.endswith("Root") or "TemplateSwitch" in t:
        return False, False
    raise ValueError(f"unknown alignment op {t!r}")


class MultipairAlignmentRenderer:
    def __init__(self, label: str, sequence: str):
        self.rows: Dict[str, List[object]] = {label: list(sequence)}

    def _col_of(self, row: List[object], seq_offset: int) -> int:
        """Smallest column index skipping the first `seq_offset` non-blank,
        non-gap characters of `row` (translate_alignment_offset)."""
        seen = 0
        for col, c in enumerate(row):
            if seen >= seq_offset and c not in (BLANK, GAP):
                if seen == seq_offset:
                    return col
            if c not in (BLANK, GAP):
                seen += 1
        if seen == seq_offset:
            return len(row)
        raise IndexError(f"offset {seq_offset} beyond row of {seen} chars")

    def _insert_column(self, col: int, skip_label: str) -> None:
        for lbl, row in self.rows.items():
            if lbl == skip_label or col >= len(row):
                continue
            in_leading = all(c is BLANK for c in row[:col])
            in_trailing = all(c is BLANK for c in row[col:])
            row.insert(col, BLANK if in_leading or in_trailing else GAP)

    def add_aligned_sequence(
        self,
        base_label: str,
        base_offset: int,
        label: str,
        sequence: str,
        ops: Iterable[Tuple[bool, bool]],
        *,
        render_gaps: bool = True,
    ) -> None:
        """Align `sequence` against the `base_label` row starting at its
        sequence offset `base_offset`.  `ops` yields (consumes_new,
        consumes_base) pairs (use `op_consumes` + role mapping)."""
        base = self.rows[base_label]
        col = self._col_of(base, base_offset)
        new_row: List[object] = [BLANK] * col
        it = iter(sequence)
        for consumes_new, consumes_base in ops:
            if not consumes_new and not consumes_base:
                continue
            if consumes_base:
                # advance over the base row's gap/blank columns first
                while col < len(base) and base[col] in (BLANK, GAP):
                    new_row.append(GAP if render_gaps else BLANK)
                    col += 1
            if consumes_new and consumes_base:
                new_row.append(next(it))
                col += 1
            elif consumes_base:
                new_row.append(GAP if render_gaps else BLANK)
                col += 1
            else:  # insertion relative to base: new column for everyone
                # reuse an existing gap column of the base row if present
                if col < len(base) and base[col] in (BLANK, GAP):
                    new_row.append(next(it))
                    col += 1
                else:
                    self._insert_column(col, label)
                    new_row.append(next(it))
                    col += 1
        self.rows[label] = new_row

    def render(self, out: TextIO, names: List[str]) -> None:
        width = max(len(n) for n in names)
        for name in names:
            row = self.rows[name]
            text = "".join(" " if c is BLANK else c for c in row).rstrip()
            out.write(f"{name}: {' ' * (width - len(name))}{text}\n")
