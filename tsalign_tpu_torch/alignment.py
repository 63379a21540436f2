"""Alignment edge types and the run-length-encoded alignment container.

Mirrors lib_tsalign/src/a_star_aligner/template_switch_distance/alignment_type.rs
(edge alphabet, RLE merge rules, CIGAR rendering at display.rs:8-41) and
lib_tsalign/src/a_star_aligner/alignment_result/alignment.rs (RLE container).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple, Union

# Simple (unit) alignment types are plain strings:
PRIMARY_INSERTION = "PrimaryInsertion"
PRIMARY_DELETION = "PrimaryDeletion"
PRIMARY_SUBSTITUTION = "PrimarySubstitution"
PRIMARY_MATCH = "PrimaryMatch"
PRIMARY_FLANK_INSERTION = "PrimaryFlankInsertion"
PRIMARY_FLANK_DELETION = "PrimaryFlankDeletion"
PRIMARY_FLANK_SUBSTITUTION = "PrimaryFlankSubstitution"
PRIMARY_FLANK_MATCH = "PrimaryFlankMatch"
SECONDARY_INSERTION = "SecondaryInsertion"
SECONDARY_DELETION = "SecondaryDeletion"
SECONDARY_SUBSTITUTION = "SecondarySubstitution"
SECONDARY_MATCH = "SecondaryMatch"
ROOT = "Root"
SECONDARY_ROOT = "SecondaryRoot"
PRIMARY_REENTRY = "PrimaryReentry"

_CIGAR_CHAR = {
    PRIMARY_INSERTION: "I",
    PRIMARY_FLANK_INSERTION: "I",
    SECONDARY_INSERTION: "I",
    PRIMARY_DELETION: "D",
    PRIMARY_FLANK_DELETION: "D",
    SECONDARY_DELETION: "D",
    PRIMARY_SUBSTITUTION: "X",
    PRIMARY_FLANK_SUBSTITUTION: "X",
    SECONDARY_SUBSTITUTION: "X",
    PRIMARY_MATCH: "=",
    PRIMARY_FLANK_MATCH: "=",
    SECONDARY_MATCH: "=",
    ROOT: "",
    SECONDARY_ROOT: "",
    PRIMARY_REENTRY: "",
}

_MERGE_GROUP = {
    PRIMARY_INSERTION: "pI",
    PRIMARY_FLANK_INSERTION: "pI",
    PRIMARY_DELETION: "pD",
    PRIMARY_FLANK_DELETION: "pD",
    PRIMARY_SUBSTITUTION: "pX",
    PRIMARY_FLANK_SUBSTITUTION: "pX",
    PRIMARY_MATCH: "pM",
    PRIMARY_FLANK_MATCH: "pM",
}


@dataclass(frozen=True)
class EqualCostRange:
    min_start: int
    max_start: int
    min_end: int
    max_end: int

    @classmethod
    def new_invalid(cls) -> "EqualCostRange":
        return cls(1, -1, 1, -1)

    def is_valid(self) -> bool:
        return (
            self.min_start <= 0
            and self.max_start >= 0
            and self.min_end <= 0
            and self.max_end >= 0
        )

    def __str__(self):
        if self.is_valid():
            return f"[{self.min_start},{self.max_start}]:[{self.min_end},{self.max_end}]"
        return "[-]:[-]"


@dataclass(frozen=True)
class TemplateSwitchEntrance:
    first_offset: int
    equal_cost_range: EqualCostRange
    primary: str  # "Reference" | "Query"
    secondary: str  # "Reference" | "Query"
    direction: str  # "Forward" | "Reverse"

    def __str__(self):
        p = "R" if self.primary == "Reference" else "Q"
        s = "R" if self.secondary == "Reference" else "Q"
        d = "F" if self.direction == "Forward" else "R"
        return f"[TS{p}{s}{d}:{self.equal_cost_range}:{self.first_offset}:"


@dataclass(frozen=True)
class TemplateSwitchExit:
    anti_primary_gap: int

    def __str__(self):
        return f":{self.anti_primary_gap}]"


AlignmentType = Union[str, TemplateSwitchEntrance, TemplateSwitchExit]


def is_internal(t: AlignmentType) -> bool:
    return t in (ROOT, SECONDARY_ROOT, PRIMARY_REENTRY)


def is_repeatable(t: AlignmentType) -> bool:
    return isinstance(t, str)


def is_repeated(t: AlignmentType, previous: AlignmentType) -> bool:
    """RLE merge rule (alignment_type.rs:101-139)."""
    if isinstance(t, str) and isinstance(previous, str):
        g1 = _MERGE_GROUP.get(t)
        g2 = _MERGE_GROUP.get(previous)
        if g1 is not None and g1 == g2:
            return True
        return t == previous
    if isinstance(t, TemplateSwitchEntrance) and isinstance(previous, TemplateSwitchEntrance):
        return t.primary == previous.primary and t.secondary == previous.secondary
    if isinstance(t, TemplateSwitchExit) and isinstance(previous, TemplateSwitchExit):
        return True
    return t == previous


def is_template_switch_exit(t: AlignmentType) -> bool:
    return isinstance(t, TemplateSwitchExit)


def is_template_switch_entrance(t: AlignmentType) -> bool:
    return isinstance(t, TemplateSwitchEntrance)


class Alignment:
    """Run-length-encoded alignment: list of (count, AlignmentType)."""

    def __init__(self, entries: List[Tuple[int, AlignmentType]] = None):
        self.entries: List[Tuple[int, AlignmentType]] = list(entries or [])

    def __eq__(self, other):
        return isinstance(other, Alignment) and self.entries == other.entries

    def __repr__(self):
        return f"Alignment({self.entries})"

    def push(self, t: AlignmentType, n: int = 1) -> None:
        if self.entries and self.entries[-1][1] == t:
            count, _ = self.entries[-1]
            self.entries[-1] = (count + n, t)
        else:
            self.entries.append((n, t))

    def ts_total_length(self) -> int:
        """Total template-switch length: the primary characters consumed
        inside template switches (secondary matches, substitutions and
        insertions), what the length cost and the tie-break's bonus count."""
        return sum(
            n for n, t in self.entries
            if t in (SECONDARY_MATCH, SECONDARY_SUBSTITUTION, SECONDARY_INSERTION)
        )

    def iter_flat(self):
        """Flat op stream; non-repeatable ops (entrances/exits) yield once
        regardless of their RLE multiplicity (iter.rs:62-84)."""
        for count, t in self.entries:
            for _ in range(count if is_repeatable(t) else min(1, count)):
                yield t

    def cigar(self) -> str:
        out = []
        for count, t in self.entries:
            if is_repeatable(t):
                out.append(f"{count}{_CIGAR_CHAR[t]}")
            else:
                out.append(str(t))
        return "".join(out)

    def reverse(self) -> "Alignment":
        """Reversed RLE (alignment.rs reverse())."""
        return Alignment(list(reversed(self.entries)))

    def inverted(self) -> "Alignment":
        """Swap the roles of reference and query
        (alignment_type.rs:152-199 inverted()): insertions become deletions
        and vice versa, entrance primary/secondary labels flip sequence."""

        def flip(t):
            if isinstance(t, str):
                swaps = {
                    PRIMARY_INSERTION: PRIMARY_DELETION,
                    PRIMARY_DELETION: PRIMARY_INSERTION,
                    PRIMARY_FLANK_INSERTION: PRIMARY_FLANK_DELETION,
                    PRIMARY_FLANK_DELETION: PRIMARY_FLANK_INSERTION,
                }
                return swaps.get(t, t)
            if isinstance(t, TemplateSwitchEntrance):
                other = {"Reference": "Query", "Query": "Reference"}
                return TemplateSwitchEntrance(
                    first_offset=t.first_offset,
                    equal_cost_range=t.equal_cost_range,
                    primary=other[t.primary],
                    secondary=other[t.secondary],
                    direction=t.direction,
                )
            return t

        return Alignment([(n, flip(t)) for n, t in self.entries])

    @classmethod
    def from_edge_sequence(cls, edges) -> "Alignment":
        """Compress a forward-ordered edge list with the reference's merge rule.

        The reference compresses while backtracking (target -> root) and then
        reverses (a_star_aligner.rs:104-122); merging from the back keeps the
        *last* edge's payload for merged non-repeatable runs (e.g. the final
        first_offset of an entrance-offset walk).  We replicate by compressing
        the reversed list and reversing the result.
        """
        rle_rev: List[Tuple[int, AlignmentType]] = []
        for t in reversed(list(edges)):
            if is_internal(t):
                continue
            if rle_rev and is_repeated(t, rle_rev[-1][1]):
                count, kept = rle_rev[-1]
                rle_rev[-1] = (count + 1, kept)
            else:
                rle_rev.append((1, t))
        return cls(list(reversed(rle_rev)))
