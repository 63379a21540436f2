"""Alignment ranges (focus regions) — mirrors lib_tsalign alignment_geometry.rs."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class AlignmentRange:
    reference_offset: int
    query_offset: int
    reference_limit: int
    query_limit: int

    @classmethod
    def complete(cls, reference_length: int, query_length: int) -> "AlignmentRange":
        return cls(0, 0, reference_length, query_length)

    def reference_range(self):
        return range(self.reference_offset, self.reference_limit)

    def query_range(self):
        return range(self.query_offset, self.query_limit)

    def __str__(self):
        return (
            f"R: {self.reference_offset}..{self.reference_limit}; "
            f"Q: {self.query_offset}..{self.query_limit}"
        )
