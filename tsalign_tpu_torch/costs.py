"""Cost model primitives: piecewise-constant cost functions and gap-affine tables.

Semantics replicate the reference exactly:
  * CostFunction — sorted step function, evaluate = binary search
    (lib_tsalign/src/costs/cost_function.rs:36-47), V-shape check (:170-176),
    min over range (:68-127), min/max finite input (:49-60, :130-153).
  * GapAffineCostTable — named substitution matrix + per-character gap open /
    extend vectors with cached minima (lib_tsalign/src/costs/gap_affine.rs).

Costs are exact Python integers.  Infinity is the sentinel `INF`; arithmetic
must saturate at INF (the reference uses u64::MAX with checked/saturating ops,
generic_a_star/src/cost.rs).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .alphabet import Alphabet

# The reference uses u64::MAX as infinity.  We keep a large exact integer that
# survives a few saturating additions without overflowing device int32 when
# clamped later.
INF = 2**62

# Sentinel for "negative infinity" source coordinates (isize::MIN analog).
NEG_INF_INPUT = -(2**62)
POS_INF_INPUT = 2**62


def sat_add(a: int, b: int) -> int:
    """Saturating addition on costs."""
    if a >= INF or b >= INF:
        return INF
    return a + b


def sat_add_many(*costs: int) -> int:
    total = 0
    for c in costs:
        if c >= INF:
            return INF
        total += c
    return min(total, INF)


class CostFunction:
    """A piecewise-constant step function over integers.

    Represented as a sorted list of (input, cost) points; the function's domain
    starts at the first input; f(x) = cost of the last point with input <= x.
    """

    def __init__(self, points: Sequence[Tuple[int, int]]):
        points = list(points)
        for (a, _), (b, _) in zip(points, points[1:]):
            if a >= b:
                raise ValueError("CostFunction inputs must be strictly increasing")
        if not points:
            raise ValueError("CostFunction must have at least one point")
        self.points: List[Tuple[int, int]] = points
        self._inputs = [p[0] for p in points]

    def __repr__(self):
        return f"CostFunction({self.points})"

    def __eq__(self, other):
        return isinstance(other, CostFunction) and self.points == other.points

    def evaluate(self, x: int) -> int:
        i = bisect.bisect_right(self._inputs, x)
        if i == 0:
            raise ValueError(f"CostFunction evaluated below domain: {x} < {self._inputs[0]}")
        return self.points[i - 1][1]

    def min_in(self, start: int, end: int) -> Optional[int]:
        """Minimum cost over the half-open integer range [start, end).

        Mirrors CostFunction::min (cost_function.rs:68-127) for the
        Included(start)..Excluded(end) case used by the aligner.
        """
        if start >= end:
            return None
        best = None
        for idx, (first_input, cost) in enumerate(self.points):
            if idx + 1 < len(self.points):
                last_input = self.points[idx + 1][0] - 1
            else:
                last_input = POS_INF_INPUT
            if first_input < end and start <= last_input:
                if best is None or cost < best:
                    best = cost
        return best

    def min_from(self, start: int) -> Optional[int]:
        """Minimum cost over [start, +inf)."""
        return self.min_in(start, POS_INF_INPUT)

    def minimum_finite_input(self) -> Optional[int]:
        for x, c in self.points:
            if c < INF:
                return x
        return None

    def maximum_finite_input(self) -> Optional[int]:
        """Largest input with finite cost, or None if unbounded/absent.

        Mirrors cost_function.rs:130-153: None if the last segment is finite
        (unbounded finite domain).
        """
        last_finite = None
        for i, (_, c) in enumerate(self.points):
            if c < INF:
                last_finite = i
        if last_finite is None:
            return None
        if last_finite + 1 == len(self.points):
            return None
        return self.points[last_finite + 1][0] - 1

    def is_v_shaped(self) -> bool:
        for (x0, c0), (x1, c1) in zip(self.points, self.points[1:]):
            ok = (
                (x0 < 0 and x1 > 0)
                or (x0 < 0 and c0 >= c1)
                or (x0 >= 0 and c0 <= c1)
            )
            if not ok:
                return False
        return True

    def scale(self, factor: int) -> "CostFunction":
        """Multiply all finite costs by `factor` (INF saturates)."""
        return CostFunction(
            [(x, c * factor if c < INF else INF) for x, c in self.points]
        )

    def finite_window(self) -> Optional[Tuple[int, int]]:
        """Inclusive (lo, hi) span of inputs with finite cost; None if all inf.

        hi may be POS_INF_INPUT when the finite domain is unbounded above.
        """
        lo = self.minimum_finite_input()
        if lo is None:
            return None
        hi = self.maximum_finite_input()
        if hi is None:
            hi = POS_INF_INPUT
        return (lo, hi)

    def to_dense(self, lo: int, hi: int) -> np.ndarray:
        """Evaluate on [lo, hi] inclusive into an int64 array (INF preserved)."""
        return np.array([self.evaluate(x) for x in range(lo, hi + 1)], dtype=np.int64)

    # --- plain text IO (config.tsa format) ---

    def display(self) -> str:
        """Two-row plain text: inputs then costs, as written by the reference."""
        ins = []
        cs = []
        for x, c in self.points:
            ins.append(_fmt_input(x))
            cs.append(_fmt_cost(c))
        width = [max(len(a), len(b)) for a, b in zip(ins, cs)]
        row1 = " ".join(s.rjust(w) for s, w in zip(ins, width))
        row2 = " ".join(s.rjust(w) for s, w in zip(cs, width))
        return f" {row1}\n {row2}"


def _fmt_input(x: int) -> str:
    if x <= NEG_INF_INPUT:
        return "-inf"
    if x >= POS_INF_INPUT:
        return "inf"
    return str(x)


def _fmt_cost(c: int) -> str:
    return "inf" if c >= INF else str(c)


def _parse_value(tok: str, signed: bool) -> int:
    t = tok.strip()
    if t in ("inf", "+inf"):
        return INF if not signed else POS_INF_INPUT
    if t == "-inf":
        return NEG_INF_INPUT
    return int(t)


def parse_cost_function(tokens_inputs: Sequence[str], tokens_costs: Sequence[str]) -> CostFunction:
    if len(tokens_inputs) != len(tokens_costs):
        raise ValueError("cost function rows have different lengths")
    pts = []
    for ti, tc in zip(tokens_inputs, tokens_costs):
        x = _parse_value(ti, signed=True)
        c = _parse_value(tc, signed=False)
        if c >= POS_INF_INPUT:
            c = INF
        pts.append((x, c))
    return CostFunction(pts)


@dataclass
class GapAffineCostTable:
    """Substitution matrix + gap open/extend vectors, indexed by alphabet index."""

    name: str
    alphabet: Alphabet
    substitution: np.ndarray  # (size, size) int64, INF-capped
    gap_open: np.ndarray  # (size,) int64
    gap_extend: np.ndarray  # (size,) int64

    def __eq__(self, other):
        return (
            isinstance(other, GapAffineCostTable)
            and self.name == other.name
            and self.alphabet.letters == other.alphabet.letters
            and np.array_equal(self.substitution, other.substitution)
            and np.array_equal(self.gap_open, other.gap_open)
            and np.array_equal(self.gap_extend, other.gap_extend)
        )

    @classmethod
    def base_agnostic(
        cls,
        name: str,
        alphabet: Alphabet,
        match_cost: int,
        substitution_cost: int,
        gap_open_cost: int,
        gap_extend_cost: int,
    ) -> "GapAffineCostTable":
        n = alphabet.size
        sub = np.full((n, n), substitution_cost, dtype=np.int64)
        np.fill_diagonal(sub, match_cost)
        return cls(
            name=name,
            alphabet=alphabet,
            substitution=sub,
            gap_open=np.full(n, gap_open_cost, dtype=np.int64),
            gap_extend=np.full(n, gap_extend_cost, dtype=np.int64),
        )

    def scale(self, factor: int) -> "GapAffineCostTable":
        def sc(a):
            return np.where(a < INF, a * factor, INF)

        return GapAffineCostTable(
            name=self.name,
            alphabet=self.alphabet,
            substitution=sc(self.substitution),
            gap_open=sc(self.gap_open),
            gap_extend=sc(self.gap_extend),
        )

    def match_or_substitution_cost(self, c1: int, c2: int) -> int:
        return int(self.substitution[c1, c2])

    def gap_cost(self, c: int, is_first: bool) -> int:
        return int(self.gap_open[c] if is_first else self.gap_extend[c])

    def min_substitution_cost(self) -> int:
        n = self.alphabet.size
        off = self.substitution[~np.eye(n, dtype=bool)]
        return int(off.min())

    def min_match_cost(self) -> int:
        return int(np.diagonal(self.substitution).min())

    def min_gap_open_cost(self) -> int:
        return int(self.gap_open.min())

    def min_gap_extend_cost(self) -> int:
        return int(self.gap_extend.min())

    def display(self) -> str:
        letters = self.alphabet.letters
        w = max(
            [2]
            + [len(_fmt_cost(int(v))) for v in self.substitution.flat]
            + [len(_fmt_cost(int(v))) for v in self.gap_open]
            + [len(_fmt_cost(int(v))) for v in self.gap_extend]
        )
        out = [f"# {self.name}", "", "SubstitutionCostTable"]
        header = "  |" + "".join(f" {c:>{w}}" for c in letters)
        out.append(header)
        out.append("--+" + "-" * (len(header) - 3))
        for i, c in enumerate(letters):
            row = "".join(
                f" {_fmt_cost(int(v)):>{w}}" for v in self.substitution[i]
            )
            out.append(f"{c} |{row}")
        out.append("")
        out.append("GapOpenCostVector")
        out.append(" " + " ".join(letters))
        out.append(" " + " ".join(_fmt_cost(int(v)) for v in self.gap_open))
        out.append("")
        out.append("GapExtendCostVector")
        out.append(" " + " ".join(letters))
        out.append(" " + " ".join(_fmt_cost(int(v)) for v in self.gap_extend))
        return "\n".join(out)
