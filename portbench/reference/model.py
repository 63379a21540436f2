"""The cost model of one benchmark configuration, read from its JSON file.

The numbers are upstream's `TemplateSwitchConfig::default` (lib_tsalign
config.rs:219-304), written out in the configuration file; nothing is read
from the program under test.  A cost function is a list of steps
``[[x0, c0], [x1, c1], ...]``: f(x) is the cost of the last step whose input
is <= x, infinite below the first input; "-inf" and "inf" stand for the
unbounded input and the infinite cost.  `K` > 1 gives the maximise tie-break
of the total template-switch length: every cost times K and a bonus of 1 off
each primary base a template switch consumes, so a path's value is
K * cost - ts_total_length.
"""

from __future__ import annotations

INF = 1 << 29  # infinite in the reference's int32 arithmetic (sums of two stay in int32)
THRESH = 1 << 28  # a value at or above it counts as infinite
NEG_INPUT = -(1 << 62)

BASE_KEYS = ("rrf", "rqf", "qrf", "qqf", "rrr", "rqr", "qrr", "qqr")


class Fn:
    """A step cost function, scaled by K (infinite stays infinite)."""

    def __init__(self, steps, K: int = 1):
        pts = []
        for x, c in steps:
            x = NEG_INPUT if x == "-inf" else int(x)
            c = INF if c == "inf" else int(c) * K
            pts.append((x, c))
        if any(a >= b for (a, _), (b, _) in zip(pts, pts[1:])):
            raise ValueError(f"cost function inputs must increase: {steps}")
        self.pts = pts

    def __call__(self, x: int) -> int:
        c = INF
        for xi, ci in self.pts:
            if xi > x:
                break
            c = ci
        return c

    def finite_run(self, x: int, lo: int, hi: int):
        """(a, b): the widest interval around x, within [lo, hi], on which f
        is finite; None if f(x) is infinite."""
        if self(x) >= INF:
            return None
        a = x
        while a > lo and self(a - 1) < INF:
            a -= 1
        b = x
        while b < hi and self(b + 1) < INF:
            b += 1
        return a, b

    def min_from(self, x: int) -> int:
        best = self(x)
        for xi, ci in self.pts:
            if xi > x:
                best = min(best, ci)
        return best

    def first_finite_input(self):
        for x, c in self.pts:
            if c < INF:
                return x
        return None


class Table:
    """A base-agnostic gap-affine table: match, substitution, gap open,
    gap extend, each times K."""

    def __init__(self, costs, K: int = 1):
        self.match, self.sub, self.open, self.ext = (int(c) * K for c in costs)


class Model:
    def __init__(self, costs: dict, K: int = 1):
        if costs["left_flank_length"] != 0 or costs["right_flank_length"] != 0:
            raise ValueError("the plain reference covers flankless configurations only")
        self.K = K
        self.bonus = 1 if K > 1 else 0
        self.base = {k: (INF if costs["base_cost"][k] == "inf" else int(costs["base_cost"][k]) * K)
                     for k in BASE_KEYS}
        self.primary = Table(costs["primary_edit_costs"], K)
        self.secondary = (Table(costs["secondary_forward_edit_costs"], K),
                          Table(costs["secondary_reverse_edit_costs"], K))
        self.rq_qr_offset = Fn(costs["rq_qr_offset_costs"], K)
        self.rr_qq_offset = Fn(costs["rr_qq_offset_costs"], K)
        self.length = Fn(costs["length_costs"], K)
        self.length_difference = Fn(costs["length_difference_costs"], K)
        self.anti_gap = (Fn(costs["forward_anti_primary_gap_costs"], K),
                         Fn(costs["reverse_anti_primary_gap_costs"], K))
        m = self.length.first_finite_input()
        self.min_length = m if m is not None else 1 << 62

    def base_cost(self, pk: int, sk: int, dk: int) -> int:
        return self.base["rq"[pk] + "rq"[sk] + "fr"[dk]]

    def offset(self, pk: int, sk: int) -> Fn:
        return self.rr_qq_offset if pk == sk else self.rq_qr_offset


ALPHABET = "ACGT"
COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A"}


def encode(seq: str):
    return [ALPHABET.index(c) for c in seq]


def complement_code(c: int) -> int:
    return ALPHABET.index(COMPLEMENT[ALPHABET[c]])
