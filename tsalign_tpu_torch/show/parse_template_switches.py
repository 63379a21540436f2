"""Extract per-TSM views from an AlignmentResult.

Counterpart of lib_tsshow/src/plain_text/parse_template_switches.rs: walk the
RLE alignment with coordinate tracking and produce, per template switch, the
switchpoints SP1-SP4, the kind, and the op streams of the upstream primary,
the secondary (2-3) alignment and the downstream primary.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

from ..alignment import TemplateSwitchEntrance, TemplateSwitchExit
from ..result import AlignmentResult


# Context-window constants (parse_template_switches.rs:15-16).
STREAM_DEFAULT_LENGTH = 20
STREAM_PADDING = 10


@dataclass
class TSShow:
    entrance: TemplateSwitchEntrance
    exit: TemplateSwitchExit
    # SP1 (entrance) / SP4 (reentry) in primary coordinates, SP2/SP3 in
    # secondary coordinates.
    sp1_reference: int = 0
    sp1_query: int = 0
    sp2_secondary: int = 0
    sp3_secondary: int = 0
    sp4_primary: int = 0
    sp4_reference: int = 0
    sp4_query: int = 0
    length: int = 0  # primary characters consumed by the 2-3 alignment
    upstream: List[Tuple[int, object]] = field(default_factory=list)
    inner: List[Tuple[int, object]] = field(default_factory=list)
    downstream: List[Tuple[int, object]] = field(default_factory=list)
    # Context-window coordinates: where the (trimmed) upstream stream starts
    # and the downstream stream ends, in (reference, query) coordinates.
    upstream_reference: int = 0
    upstream_query: int = 0
    downstream_reference: int = 0
    downstream_query: int = 0


def _flat_len(ops: List[Tuple[int, object]]) -> int:
    return sum(c for c, _ in ops)


def _trim_tail(ops: List[Tuple[int, object]], keep: int) -> List[Tuple[int, object]]:
    """Keep the last `keep` flat ops (splitting a run if needed)."""
    out: List[Tuple[int, object]] = []
    remaining = keep
    for count, t in reversed(ops):
        if remaining <= 0:
            break
        take = min(count, remaining)
        out.append((take, t))
        remaining -= take
    out.reverse()
    return out


def _trim_head(ops: List[Tuple[int, object]], keep: int) -> List[Tuple[int, object]]:
    """Keep the first `keep` flat ops (splitting a run if needed)."""
    out: List[Tuple[int, object]] = []
    remaining = keep
    for count, t in ops:
        if remaining <= 0:
            break
        take = min(count, remaining)
        out.append((take, t))
        remaining -= take
    return out


def _advance_coords(i: int, j: int, ops, sign: int = 1) -> Tuple[int, int]:
    for count, t in ops:
        if t.endswith(("Match", "Substitution")):
            i += sign * count
            j += sign * count
        elif t.endswith("Deletion"):
            i += sign * count
        elif t.endswith("Insertion"):
            j += sign * count
    return i, j


def parse(result: AlignmentResult) -> List[TSShow]:
    if result.alignment is None:
        return []
    out: List[TSShow] = []
    i = result.reference_offset
    j = result.query_offset
    upstream: List[Tuple[int, object]] = []
    cur: TSShow = None  # type: ignore
    p_idx = s_idx = 0

    for count, t in result.alignment.entries:
        if isinstance(t, TemplateSwitchEntrance):
            cur = TSShow(entrance=t, exit=None)  # type: ignore
            cur.sp1_reference, cur.sp1_query = i, j
            e_s = (i if t.secondary == "Reference" else j) + t.first_offset
            cur.sp2_secondary = e_s
            p_idx = i if t.primary == "Reference" else j
            s_idx = e_s
            cur.upstream = list(upstream)
        elif isinstance(t, TemplateSwitchExit):
            assert cur is not None
            cur.exit = t
            cur.sp3_secondary = s_idx
            cur.sp4_primary = p_idx
            cur.length = p_idx - (
                cur.sp1_reference
                if cur.entrance.primary == "Reference"
                else cur.sp1_query
            )
            ag = t.anti_primary_gap
            if cur.entrance.primary == "Reference":
                i, j = p_idx, cur.sp1_query + ag
            else:
                i, j = cur.sp1_reference + ag, p_idx
            cur.sp4_reference, cur.sp4_query = i, j
            # Trim the upstream context to the reference's window
            # (parse_template_switches.rs:100-110): the larger of the
            # default length and the reach back to the secondary span.
            n_up = max(
                STREAM_DEFAULT_LENGTH,
                max(0, max(cur.sp1_reference, cur.sp1_query)
                    - min(cur.sp2_secondary, cur.sp3_secondary))
                + STREAM_PADDING,
            )
            cur.upstream = _trim_tail(cur.upstream, n_up)
            cur.upstream_reference, cur.upstream_query = _advance_coords(
                cur.sp1_reference, cur.sp1_query, cur.upstream, sign=-1
            )
            out.append(cur)
            upstream = []
        elif cur is not None and cur.exit is None:
            # inside the secondary alignment
            cur.inner.append((count, t))
            if t in ("SecondaryMatch", "SecondarySubstitution"):
                p_idx += count
                s_idx += count if cur.entrance.direction == "Forward" else -count
            elif t == "SecondaryDeletion":
                s_idx += count if cur.entrance.direction == "Forward" else -count
            elif t == "SecondaryInsertion":
                p_idx += count
        else:
            # primary ops: track coordinates, feed upstream / downstream
            if out:
                out[-1].downstream.append((count, t))
            upstream.append((count, t))
            if t.endswith(("Match", "Substitution")):
                i += count
                j += count
            elif t.endswith("Deletion"):
                i += count
            elif t.endswith("Insertion"):
                j += count
    for ts in out:
        # Downstream window (parse_template_switches.rs:121-130): default
        # length, or far enough to pass the secondary span.
        n_down = max(
            STREAM_DEFAULT_LENGTH,
            max(0, max(ts.sp2_secondary, ts.sp3_secondary)
                - (min(ts.sp4_reference, ts.sp4_query) + STREAM_PADDING)),
        )
        ts.downstream = _trim_head(ts.downstream, n_down)
        ts.downstream_reference, ts.downstream_query = _advance_coords(
            ts.sp4_reference, ts.sp4_query, ts.downstream, sign=1
        )
    return out
