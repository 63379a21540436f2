"""AlignmentResult: statistics + alignment, serialized to the reference's TOML schema.

Schema mirrors lib_tsalign/src/a_star_aligner/alignment_result.rs (serde with
tag = "type", flattened Alignment + AlignmentStatistics, [result] =
AStarResult tagged "astar_result_type", [sequences] = SequencePair) so the
output files are interchangeable with the reference's `tsalign align -o` TOMLs
and consumable by `show`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from .alignment import (
    Alignment,
    EqualCostRange,
    TemplateSwitchEntrance,
    TemplateSwitchExit,
    is_template_switch_exit,
)


@dataclass
class AStarResultInfo:
    """Mirrors generic_a_star::AStarResult (lib.rs:167-187), identifier skipped."""

    type: str  # FoundTarget | ExceededCostLimit | ExceededMemoryLimit | NoTarget
    cost: Optional[int] = None  # FoundTarget.cost
    cost_limit: Optional[int] = None  # ExceededCostLimit.cost_limit
    max_cost: Optional[int] = None  # ExceededMemoryLimit.max_cost

    def effective_cost(self) -> int:
        if self.type == "FoundTarget":
            return self.cost
        if self.type == "ExceededCostLimit":
            return self.cost_limit
        if self.type == "ExceededMemoryLimit":
            return self.max_cost
        return 0


@dataclass
class SequencePair:
    reference_name: str
    reference: str
    reference_rc: str
    query_name: str
    query: str
    query_rc: str


@dataclass
class AlignmentResult:
    result: AStarResultInfo
    sequences: SequencePair
    reference_offset: int
    query_offset: int

    cost: float
    cost_per_base: float
    duration_seconds: float
    opened_nodes: float
    closed_nodes: float
    suboptimal_opened_nodes: float
    suboptimal_opened_nodes_ratio: float
    template_switch_amount: float
    runtime: float = 0.0
    memory: float = 0.0

    alignment: Optional[Alignment] = None  # None => WithoutTarget

    @property
    def has_target(self) -> bool:
        return self.alignment is not None

    def cigar(self) -> str:
        return self.alignment.cigar() if self.alignment is not None else ""

    @classmethod
    def new(
        cls,
        alignment: Optional[Alignment],
        reference: str,
        query: str,
        reference_rc: str,
        query_rc: str,
        reference_name: str,
        query_name: str,
        reference_offset: int,
        query_offset: int,
        result: AStarResultInfo,
        duration_seconds: float,
        opened_nodes: int,
        closed_nodes: int,
        suboptimal_opened_nodes: int,
    ) -> "AlignmentResult":
        cost = result.effective_cost()
        total_len = len(reference) + len(query)
        if opened_nodes == 0 and suboptimal_opened_nodes == 0:
            ratio = 0.0
        else:
            denom = opened_nodes - suboptimal_opened_nodes
            ratio = suboptimal_opened_nodes / denom if denom else 0.0
        ts_amount = 0.0
        if alignment is not None:
            ts_amount = float(
                sum(1 for _, t in alignment.entries if is_template_switch_exit(t))
            )
        return cls(
            result=result,
            sequences=SequencePair(
                reference_name=reference_name,
                reference=reference,
                reference_rc=reference_rc,
                query_name=query_name,
                query=query,
                query_rc=query_rc,
            ),
            reference_offset=reference_offset,
            query_offset=query_offset,
            cost=float(cost),
            cost_per_base=(float(cost) * 2.0) / total_len if total_len else 0.0,
            duration_seconds=duration_seconds,
            opened_nodes=float(opened_nodes),
            closed_nodes=float(closed_nodes),
            suboptimal_opened_nodes=float(suboptimal_opened_nodes),
            suboptimal_opened_nodes_ratio=ratio,
            template_switch_amount=ts_amount,
            alignment=alignment,
        )

    # ------------------------------------------------------------------ TOML

    def to_toml(self) -> str:
        out = []
        if self.has_target:
            out.append('type = "WithTarget"')
            out.append(f"alignment = {_fmt_alignment(self.alignment)}")
        else:
            out.append('type = "WithoutTarget"')
        out.append(f"reference_offset = {self.reference_offset}")
        out.append(f"query_offset = {self.query_offset}")
        for key in (
            "cost",
            "cost_per_base",
            "duration_seconds",
            "opened_nodes",
            "closed_nodes",
            "suboptimal_opened_nodes",
            "suboptimal_opened_nodes_ratio",
            "template_switch_amount",
            "runtime",
            "memory",
        ):
            out.append(f"{key} = {_fmt_float(getattr(self, key))}")
        out.append("")
        out.append("[result]")
        out.append(f'astar_result_type = "{self.result.type}"')
        if self.result.type == "FoundTarget":
            out.append(f"cost = {self.result.cost}")
        elif self.result.type == "ExceededCostLimit":
            out.append(f"cost_limit = {self.result.cost_limit}")
        elif self.result.type == "ExceededMemoryLimit":
            out.append(f"max_cost = {self.result.max_cost}")
        out.append("")
        out.append("[sequences]")
        s = self.sequences
        out.append(f'reference_name = "{_escape(s.reference_name)}"')
        out.append(f'reference = "{_escape(s.reference)}"')
        out.append(f'reference_rc = "{_escape(s.reference_rc)}"')
        out.append(f'query_name = "{_escape(s.query_name)}"')
        out.append(f'query = "{_escape(s.query)}"')
        out.append(f'query_rc = "{_escape(s.query_rc)}"')
        out.append("")
        return "\n".join(out)

    @classmethod
    def from_toml(cls, text: str) -> "AlignmentResult":
        import tomllib

        data = tomllib.loads(text)
        alignment = None
        if data.get("type") == "WithTarget":
            alignment = Alignment(
                [_alignment_entry_from_toml(e) for e in data["alignment"]]
            )
        res = data.get("result", {})
        result = AStarResultInfo(
            type=res.get("astar_result_type", "NoTarget"),
            cost=res.get("cost"),
            cost_limit=res.get("cost_limit"),
            max_cost=res.get("max_cost"),
        )
        seq = data.get("sequences", {})
        return cls(
            result=result,
            sequences=SequencePair(
                reference_name=seq.get("reference_name", ""),
                reference=seq.get("reference", ""),
                reference_rc=seq.get("reference_rc", ""),
                query_name=seq.get("query_name", ""),
                query=seq.get("query", ""),
                query_rc=seq.get("query_rc", ""),
            ),
            reference_offset=data.get("reference_offset", 0),
            query_offset=data.get("query_offset", 0),
            cost=data.get("cost", 0.0),
            cost_per_base=data.get("cost_per_base", 0.0),
            duration_seconds=data.get("duration_seconds", 0.0),
            opened_nodes=data.get("opened_nodes", 0.0),
            closed_nodes=data.get("closed_nodes", 0.0),
            suboptimal_opened_nodes=data.get("suboptimal_opened_nodes", 0.0),
            suboptimal_opened_nodes_ratio=data.get("suboptimal_opened_nodes_ratio", 0.0),
            template_switch_amount=data.get("template_switch_amount", 0.0),
            runtime=data.get("runtime", 0.0),
            memory=data.get("memory", 0.0),
            alignment=alignment,
        )


def _escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"')


def _fmt_float(v: float) -> str:
    """Format like Rust's toml crate (f64 shortest-roundtrip, always with . or e)."""
    if v != v or math.isinf(v):
        return "nan" if v != v else ("inf" if v > 0 else "-inf")
    if v == int(v) and abs(v) < 1e16:
        return f"{v:.1f}"
    return repr(v)


def _fmt_alignment(alignment: Alignment) -> str:
    parts = []
    for count, t in alignment.entries:
        parts.append(f"[{count}, {_fmt_alignment_type(t)}]")
    return "[" + ", ".join(parts) + "]"


def _fmt_alignment_type(t) -> str:
    if isinstance(t, str):
        return f'"{t}"'
    if isinstance(t, TemplateSwitchEntrance):
        e = t.equal_cost_range
        ecr = (
            f"{{ min_start = {e.min_start}, max_start = {e.max_start}, "
            f"min_end = {e.min_end}, max_end = {e.max_end} }}"
        )
        return (
            "{ TemplateSwitchEntrance = { "
            f"first_offset = {t.first_offset}, equal_cost_range = {ecr}, "
            f'primary = "{t.primary}", secondary = "{t.secondary}", '
            f'direction = "{t.direction}"'
            " } }"
        )
    if isinstance(t, TemplateSwitchExit):
        return (
            "{ TemplateSwitchExit = { "
            f"anti_primary_gap = {t.anti_primary_gap}"
            " } }"
        )
    raise TypeError(f"Unknown alignment type {t!r}")


def _alignment_entry_from_toml(entry):
    count, value = entry
    if isinstance(value, str):
        return (count, value)
    if "TemplateSwitchEntrance" in value:
        v = value["TemplateSwitchEntrance"]
        ecr = v.get("equal_cost_range", {})
        return (
            count,
            TemplateSwitchEntrance(
                first_offset=v["first_offset"],
                equal_cost_range=EqualCostRange(
                    min_start=ecr.get("min_start", 1),
                    max_start=ecr.get("max_start", -1),
                    min_end=ecr.get("min_end", 1),
                    max_end=ecr.get("max_end", -1),
                ),
                primary=v["primary"],
                secondary=v["secondary"],
                direction=v["direction"],
            ),
        )
    if "TemplateSwitchExit" in value:
        v = value["TemplateSwitchExit"]
        return (count, TemplateSwitchExit(anti_primary_gap=v["anti_primary_gap"]))
    raise ValueError(f"Unknown alignment entry {entry!r}")


# --- statistics aggregation (alignment_result.rs:615-718) -----------------

_STAT_KEYS = (
    "cost",
    "cost_per_base",
    "duration_seconds",
    "opened_nodes",
    "closed_nodes",
    "suboptimal_opened_nodes",
    "suboptimal_opened_nodes_ratio",
    "template_switch_amount",
    "runtime",
    "memory",
)


def statistics_min(results):
    """Piecewise minimum over AlignmentResult statistics."""
    return {k: min(getattr(r, k) for r in results) for k in _STAT_KEYS}


def statistics_max(results):
    return {k: max(getattr(r, k) for r in results) for k in _STAT_KEYS}


def statistics_sum(results):
    return {k: sum(getattr(r, k) for r in results) for k in _STAT_KEYS}


def statistics_mean(results):
    n = len(results)
    return {k: sum(getattr(r, k) for r in results) / n for k in _STAT_KEYS}


def statistics_percentile(results, q: float):
    """Per-key q-percentile (0..1), nearest-rank."""
    out = {}
    n = len(results)
    idx = min(n - 1, max(0, round(q * (n - 1))))
    for k in _STAT_KEYS:
        vals = sorted(getattr(r, k) for r in results)
        out[k] = vals[idx]
    return out
