"""FASTA input pipeline.

Mirrors the reference CLI's character-level parser and preprocessing
(tsalign/src/align/fasta_parser.rs, tsalign/src/align.rs:302-401): pair or
separate records, skip-character stripping, uppercasing, and embedded `|`
focus-range extraction (README.md:269-306).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from .geometry import AlignmentRange


@dataclass
class FastaRecord:
    id: str
    comment: str
    sequence: str

    @property
    def display_name(self) -> str:
        # The reference formats names as "{id} {comment}" (align.rs:418-419).
        return f"{self.id} {self.comment}"


def parse_fasta_text(text: str) -> List[FastaRecord]:
    records: List[FastaRecord] = []
    current = None
    for raw_line in text.splitlines():
        line = raw_line.strip()
        if not line and current is None:
            continue
        if line.startswith(">"):
            if current is not None:
                records.append(current)
            header = line[1:]
            if " " in header or "\t" in header:
                idx = min(
                    i for i, c in enumerate(header) if c.isspace()
                )
                rid, comment = header[:idx], header[idx + 1 :]
            else:
                rid, comment = header, ""
            current = FastaRecord(id=rid, comment=comment, sequence="")
        else:
            if current is None:
                if line:
                    raise ValueError(
                        "Found non-whitespace characters before first fasta record"
                    )
                continue
            current.sequence += line
    if current is not None:
        records.append(current)
    if not records:
        raise ValueError("Input contains no fasta record")
    return records


def parse_fasta_file(path) -> List[FastaRecord]:
    with open(path, "r") as f:
        return parse_fasta_text(f.read())


def parse_pair_fasta_file(path) -> Tuple[FastaRecord, FastaRecord]:
    records = parse_fasta_file(path)
    if len(records) != 2:
        raise ValueError(
            f"Expected paired fasta file with two records, but found {len(records)}"
        )
    return records[0], records[1]


def parse_single_fasta_file(path) -> FastaRecord:
    records = parse_fasta_file(path)
    if len(records) != 1:
        raise ValueError(
            f"Expected single-record fasta file, but found {len(records)}"
        )
    return records[0]


def strip_skip_characters(sequence: str, skip_characters: str) -> str:
    if not skip_characters:
        return sequence
    skip = set(skip_characters)
    return "".join(c for c in sequence if c not in skip)


def extract_embedded_range(sequence: str, what: str) -> Tuple[str, int, int]:
    """Extract the `|...|` focus range, returning (clean_sequence, offset, limit).

    Replicates align.rs:348-374: offset = index of first '|', limit = offset +
    index of the second '|' within the remainder (i.e. the index of the last
    in-range character + 1 after removing the first delimiter).
    """
    first = sequence.find("|")
    if first < 0:
        raise ValueError(f"{what} contains no '|' character")
    second_rel = sequence[first + 1 :].find("|")
    if second_rel < 0:
        raise ValueError(f"{what} contains only one '|' character")
    limit = first + second_rel
    if "|" in sequence[first + 1 + second_rel + 1 :]:
        raise ValueError(f"{what} contains more than two '|' characters")
    return sequence.replace("|", ""), first, limit


def load_pair(
    pair_path=None,
    reference_path=None,
    query_path=None,
    skip_characters: str = "",
    use_embedded_rq_ranges: bool = False,
):
    """Full input pipeline; returns (ref_record, query_record, range_or_None)."""
    if pair_path is not None:
        reference_record, query_record = parse_pair_fasta_file(pair_path)
    elif reference_path is not None and query_path is not None:
        reference_record = parse_single_fasta_file(reference_path)
        query_record = parse_single_fasta_file(query_path)
    else:
        raise ValueError("No fasta input file given")

    if use_embedded_rq_ranges and "|" in skip_characters:
        raise ValueError(
            "Using embedded RQ ranges, but '|' is part of the skip characters"
        )

    reference_record.sequence = strip_skip_characters(
        reference_record.sequence, skip_characters
    ).upper()
    query_record.sequence = strip_skip_characters(
        query_record.sequence, skip_characters
    ).upper()

    embedded_range = None
    if use_embedded_rq_ranges:
        ref_seq, ref_off, ref_lim = extract_embedded_range(
            reference_record.sequence, "reference sequence"
        )
        qry_seq, qry_off, qry_lim = extract_embedded_range(
            query_record.sequence, "query sequence"
        )
        reference_record.sequence = ref_seq
        query_record.sequence = qry_seq
        embedded_range = AlignmentRange(ref_off, qry_off, ref_lim, qry_lim)

    return reference_record, query_record, embedded_range
