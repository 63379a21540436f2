"""TemplateSwitchConfig: the full cost model, with config.tsa parsing.

Mirrors lib_tsalign/src/config.rs (struct layout, verify(), cost selection
helpers) and lib_tsalign/src/config/io.rs (strict-order plain-text format,
`inf` literals, template_switch_min_length derived as the first finite input
of the Length cost function, io.rs:82-87).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from .alphabet import Alphabet
from .costs import (
    INF,
    CostFunction,
    GapAffineCostTable,
    _parse_value,
    parse_cost_function,
)

# TSM kind encoding: primary in {R, Q}, secondary in {R, Q}, direction in {F, Rev}.
PRIMARY_REFERENCE = "Reference"
PRIMARY_QUERY = "Query"
SECONDARY_REFERENCE = "Reference"
SECONDARY_QUERY = "Query"
DIR_FORWARD = "Forward"
DIR_REVERSE = "Reverse"

BASE_COST_KEYS = ("rrf", "rqf", "qrf", "qqf", "rrr", "rqr", "qrr", "qqr")


def base_cost_key(primary: str, secondary: str, direction: str) -> str:
    p = "r" if primary == PRIMARY_REFERENCE else "q"
    s = "r" if secondary == SECONDARY_REFERENCE else "q"
    d = "f" if direction == DIR_FORWARD else "r"
    return p + s + d


@dataclass
class TemplateSwitchConfig:
    alphabet: Alphabet

    left_flank_length: int
    right_flank_length: int

    base_cost: dict  # key in BASE_COST_KEYS -> int cost

    primary_edit_costs: GapAffineCostTable
    secondary_forward_edit_costs: GapAffineCostTable
    secondary_reverse_edit_costs: GapAffineCostTable
    left_flank_edit_costs: GapAffineCostTable
    right_flank_edit_costs: GapAffineCostTable

    rq_qr_offset_costs: CostFunction
    rr_qq_offset_costs: CostFunction
    length_costs: CostFunction
    length_difference_costs: CostFunction
    forward_anti_primary_gap_costs: CostFunction
    reverse_anti_primary_gap_costs: CostFunction

    # When nonzero, every primary-consuming secondary edge (SecondaryMatch /
    # Substitution / Insertion) is discounted by this amount.  Used by the
    # maximise-TS-total-length tie-break: costs are scaled by K and the
    # bonus set to 1, making path values K*cost - ts_total_length
    # (strategies/template_switch_total_length.rs semantics).
    secondary_length_bonus: int = 0

    @property
    def template_switch_min_length(self) -> int:
        m = self.length_costs.minimum_finite_input()
        return m if m is not None else 2**62

    def verify(self) -> None:
        if not self.rq_qr_offset_costs.is_v_shaped():
            raise ValueError("RQQROffset costs are not V-shaped")
        if not self.rr_qq_offset_costs.is_v_shaped():
            raise ValueError("RRQQOffset costs are not V-shaped")
        if not self.length_difference_costs.is_v_shaped():
            raise ValueError("LengthDifference costs are not V-shaped")

    # --- selection helpers (config.rs:87-128) ---

    def secondary_edit_costs(self, direction: str) -> GapAffineCostTable:
        return (
            self.secondary_forward_edit_costs
            if direction == DIR_FORWARD
            else self.secondary_reverse_edit_costs
        )

    def anti_primary_gap_costs(self, direction: str) -> CostFunction:
        return (
            self.forward_anti_primary_gap_costs
            if direction == DIR_FORWARD
            else self.reverse_anti_primary_gap_costs
        )

    def offset_costs(self, primary: str, secondary: str) -> CostFunction:
        same = (primary == PRIMARY_REFERENCE) == (secondary == SECONDARY_REFERENCE)
        return self.rr_qq_offset_costs if same else self.rq_qr_offset_costs

    def get_base_cost(self, primary: str, secondary: str, direction: str) -> int:
        return self.base_cost[base_cost_key(primary, secondary, direction)]

    # --- IO ---

    @classmethod
    def from_path(cls, path, alphabet: Alphabet) -> "TemplateSwitchConfig":
        with open(path, "r") as f:
            return cls.parse_plain(f.read(), alphabet)

    @classmethod
    def parse_plain(cls, text: str, alphabet: Alphabet) -> "TemplateSwitchConfig":
        p = _Parser(text)

        p.expect_section("Limits")
        left_flank_length = p.expect_equals_value("left_flank_length")
        right_flank_length = p.expect_equals_value("right_flank_length")

        p.expect_section("Base Cost")
        base_cost = {}
        for key in BASE_COST_KEYS:
            base_cost[key] = p.expect_equals_value(f"{key}_cost", signed=False)

        p.expect_section("Jump Costs")
        rq_qr = p.expect_cost_function("RQQROffset")
        rr_qq = p.expect_cost_function("RRQQOffset")
        length = p.expect_cost_function("Length")
        length_difference = p.expect_cost_function("LengthDifference")
        forward_gap = p.expect_cost_function("ForwardAntiPrimaryGap")
        reverse_gap = p.expect_cost_function("ReverseAntiPrimaryGap")

        primary = p.expect_cost_table("Primary Edit Costs", alphabet)
        secondary_forward = p.expect_cost_table("Secondary Forward Edit Costs", alphabet)
        secondary_reverse = p.expect_cost_table("Secondary Reverse Edit Costs", alphabet)
        left_flank = p.expect_cost_table("Left Flank Edit Costs", alphabet)
        right_flank = p.expect_cost_table("Right Flank Edit Costs", alphabet)

        config = cls(
            alphabet=alphabet,
            left_flank_length=left_flank_length,
            right_flank_length=right_flank_length,
            base_cost=base_cost,
            primary_edit_costs=primary,
            secondary_forward_edit_costs=secondary_forward,
            secondary_reverse_edit_costs=secondary_reverse,
            left_flank_edit_costs=left_flank,
            right_flank_edit_costs=right_flank,
            rq_qr_offset_costs=rq_qr,
            rr_qq_offset_costs=rr_qq,
            length_costs=length,
            length_difference_costs=length_difference,
            forward_anti_primary_gap_costs=forward_gap,
            reverse_anti_primary_gap_costs=reverse_gap,
        )
        config.verify()
        return config

    def display(self) -> str:
        out = ["# Limits", ""]
        out.append(f"left_flank_length = {self.left_flank_length}")
        out.append(f"right_flank_length = {self.right_flank_length}")
        out.append("")
        out.append("# Base Cost")
        out.append("")
        for key in BASE_COST_KEYS:
            v = self.base_cost[key]
            out.append(f"{key}_cost = {'inf' if v >= INF else v}")
        out.append("")
        out.append("# Jump Costs")
        for name, fn in (
            ("RQQROffset", self.rq_qr_offset_costs),
            ("RRQQOffset", self.rr_qq_offset_costs),
            ("Length", self.length_costs),
            ("LengthDifference", self.length_difference_costs),
            ("ForwardAntiPrimaryGap", self.forward_anti_primary_gap_costs),
            ("ReverseAntiPrimaryGap", self.reverse_anti_primary_gap_costs),
        ):
            out.append("")
            out.append(name)
            out.append(fn.display())
        for table in (
            self.primary_edit_costs,
            self.secondary_forward_edit_costs,
            self.secondary_reverse_edit_costs,
            self.left_flank_edit_costs,
            self.right_flank_edit_costs,
        ):
            out.append("")
            out.append(table.display())
        out.append("")
        return "\n".join(out)

    def can_rewind(self) -> bool:
        """True when any anti-primary-gap function admits a finite negative
        gap: a TSM reentry can then move the anti coordinate backwards, so
        primary positions may be consumed repeatedly across TSMs and the
        total-TS-length tie-break discount is no longer bounded by
        n_r + n_q (see aligner._run_engine's K-soundness guard)."""
        for fn in (
            self.forward_anti_primary_gap_costs,
            self.reverse_anti_primary_gap_costs,
        ):
            w = fn.finite_window()
            if w is not None and int(w[0]) < 0:
                return True
        return False

    def scaled_for_length_tiebreak(self, factor: int) -> "TemplateSwitchConfig":
        """K-scaled copy with secondary_length_bonus = 1 (lexicographic
        (cost, -ts_total_length) optimization in one integer)."""
        from dataclasses import replace

        base = {
            k: (v * factor if v < INF else INF) for k, v in self.base_cost.items()
        }
        return replace(
            self,
            base_cost=base,
            primary_edit_costs=self.primary_edit_costs.scale(factor),
            secondary_forward_edit_costs=self.secondary_forward_edit_costs.scale(factor),
            secondary_reverse_edit_costs=self.secondary_reverse_edit_costs.scale(factor),
            left_flank_edit_costs=self.left_flank_edit_costs.scale(factor),
            right_flank_edit_costs=self.right_flank_edit_costs.scale(factor),
            rq_qr_offset_costs=self.rq_qr_offset_costs.scale(factor),
            rr_qq_offset_costs=self.rr_qq_offset_costs.scale(factor),
            length_costs=self.length_costs.scale(factor),
            length_difference_costs=self.length_difference_costs.scale(factor),
            forward_anti_primary_gap_costs=self.forward_anti_primary_gap_costs.scale(factor),
            reverse_anti_primary_gap_costs=self.reverse_anti_primary_gap_costs.scale(factor),
            secondary_length_bonus=1,
        )

    @classmethod
    def default(cls, alphabet: Alphabet) -> "TemplateSwitchConfig":
        """Mirror of TemplateSwitchConfig::default (config.rs:219-304)."""
        mk = GapAffineCostTable.base_agnostic
        return cls(
            alphabet=alphabet,
            left_flank_length=0,
            right_flank_length=0,
            base_cost={
                "rrf": 4, "rqf": 4, "qrf": 4, "qqf": 4,
                "rrr": 3, "rqr": 2, "qrr": 2, "qqr": 3,
            },
            primary_edit_costs=mk("Primary Edit Costs", alphabet, 0, 2, 3, 1),
            secondary_forward_edit_costs=mk("Secondary Forward Edit Costs", alphabet, 0, 2, 3, 1),
            secondary_reverse_edit_costs=mk("Secondary Reverse Edit Costs", alphabet, 0, 2, 3, 1),
            left_flank_edit_costs=mk("Left Flank Edit Costs", alphabet, 0, 2, 3, 1),
            right_flank_edit_costs=mk("Right Flank Edit Costs", alphabet, 0, 2, 3, 1),
            rq_qr_offset_costs=CostFunction([(-(2**62), INF), (-100, 0), (101, INF)]),
            rr_qq_offset_costs=CostFunction([(-(2**62), INF), (-100, 0), (1, INF)]),
            length_costs=CostFunction([(0, INF), (5, 0)]),
            length_difference_costs=CostFunction([(-(2**62), INF), (-100, 0), (101, INF)]),
            forward_anti_primary_gap_costs=CostFunction([(-(2**62), INF), (-100, 0), (101, INF)]),
            reverse_anti_primary_gap_costs=CostFunction([(-(2**62), INF), (-100, 0), (101, INF)]),
        )


class _Parser:
    """Strict-order tokenizing parser for the config.tsa format."""

    def __init__(self, text: str):
        self.lines = text.splitlines()
        self.pos = 0

    def _peek_nonempty(self) -> str:
        while self.pos < len(self.lines) and not self.lines[self.pos].strip():
            self.pos += 1
        if self.pos >= len(self.lines):
            raise ValueError("Unexpected end of config file")
        return self.lines[self.pos]

    def _next_nonempty(self) -> str:
        line = self._peek_nonempty()
        self.pos += 1
        return line

    def expect_section(self, name: str) -> None:
        line = self._next_nonempty().strip()
        if not line.startswith("#") or line[1:].strip() != name:
            raise ValueError(f"Expected section '# {name}', found {line!r}")

    def expect_equals_value(self, identifier: str, signed: bool = True) -> int:
        line = self._next_nonempty().strip()
        m = re.match(r"^([A-Za-z0-9_]+)\s*=\s*([+-]?(?:inf|\d+))\s*$", line)
        if not m or m.group(1) != identifier:
            raise ValueError(f"Expected '{identifier} = <value>', found {line!r}")
        v = _parse_value(m.group(2), signed=signed)
        if not signed and v >= 2**62:
            v = INF
        return v

    def expect_cost_function(self, name: str) -> CostFunction:
        line = self._next_nonempty().strip()
        if line != name:
            raise ValueError(f"Expected cost function {name!r}, found {line!r}")
        inputs = self._next_nonempty().split()
        costs = self._next_nonempty().split()
        return parse_cost_function(inputs, costs)

    def expect_cost_table(self, name: str, alphabet: Alphabet) -> GapAffineCostTable:
        line = self._next_nonempty().strip()
        if not line.startswith("#") or line[1:].strip() != name:
            raise ValueError(f"Expected table section '# {name}', found {line!r}")
        line = self._next_nonempty().strip()
        if line != "SubstitutionCostTable":
            raise ValueError(f"Expected 'SubstitutionCostTable', found {line!r}")

        header = self._next_nonempty()
        if "|" not in header:
            raise ValueError(f"Malformed substitution table header: {header!r}")
        columns = header.split("|", 1)[1].split()
        self._next_nonempty()  # separator line --+----

        n = alphabet.size
        if sorted(columns) != sorted(alphabet.letters):
            raise ValueError(
                f"Substitution table columns {columns} do not match alphabet "
                f"{alphabet.letters!r}"
            )
        sub = np.full((n, n), INF, dtype=np.int64)
        for _ in range(n):
            row = self._next_nonempty()
            label, rest = row.split("|", 1)
            r = alphabet.index(label.strip())
            values = rest.split()
            if len(values) != n:
                raise ValueError(f"Substitution row has {len(values)} values, expected {n}")
            for col_letter, tok in zip(columns, values):
                c = alphabet.index(col_letter)
                v = _parse_value(tok, signed=False)
                sub[r, c] = INF if v >= 2**62 else v

        gap_open = self._expect_vector("GapOpenCostVector", alphabet)
        gap_extend = self._expect_vector("GapExtendCostVector", alphabet)

        return GapAffineCostTable(
            name=name,
            alphabet=alphabet,
            substitution=sub,
            gap_open=gap_open,
            gap_extend=gap_extend,
        )

    def _expect_vector(self, name: str, alphabet: Alphabet) -> np.ndarray:
        line = self._next_nonempty().strip()
        if line != name:
            raise ValueError(f"Expected {name!r}, found {line!r}")
        letters = self._next_nonempty().split()
        values = self._next_nonempty().split()
        if sorted(letters) != sorted(alphabet.letters) or len(values) != len(letters):
            raise ValueError(f"Malformed {name}: letters {letters}, values {values}")
        vec = np.full(alphabet.size, INF, dtype=np.int64)
        for letter, tok in zip(letters, values):
            v = _parse_value(tok, signed=False)
            vec[alphabet.index(letter)] = INF if v >= 2**62 else v
        return vec
