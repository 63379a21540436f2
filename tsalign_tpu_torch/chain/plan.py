"""Chained-mode preprocessing plan cache (`.tsc` counterpart).

The reference's `tsalign preprocess` computes ChainingLowerBounds
(gap-affine + TS-jump lower-bound tables) keyed by `sha1(costs)-{k}-{max_n}`
and the chain aligner loads them from the cache directory, computing and
storing them on the fly when absent, and refusing to compute under
`--force-no-preprocessing` (tsalign/src/util.rs:46-66,
tsalign/src/align/a_star_chain_ts.rs:49-70,
lib_ts_chainalign/src/chaining_lower_bounds.rs:25-48).

The dense chained mode needs much lighter planning data, all derived from
the config:

  * the chain DP's scoring slopes — per-char match gain and per-unit
    diagonal-drift penalty, the slope counterparts of the reference's
    GapAffineLowerBounds gap tables (chaining_lower_bounds/gap_affine.rs);
  * the TSM locality window radius, which bounds how far a template switch
    can reach across a segment cut (the role the TS-jump lower bounds play
    in making chain gaps soundly priceable);
  * the minimum exact-run length for placing cuts (`2k + 8`).

These derive in milliseconds, so the cache's value is operational parity
(inspectable artifacts, `--force-no-preprocessing`) rather than compute
savings; the loader mirrors the reference's load-else-compute-and-store
protocol, including the consistency assertions on load.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import asdict, dataclass
from typing import Optional

import numpy as np

from ..config import TemplateSwitchConfig
from ..costs import INF


class PlanCacheError(RuntimeError):
    """Missing or inconsistent preprocessing cache."""


def config_digest(config: TemplateSwitchConfig) -> str:
    """sha1 over the config's canonical display serialization (counterpart
    of sha1(bincode(costs)), util.rs:53-58)."""
    return hashlib.sha1(config.display().encode()).hexdigest()


def infer_max_n(n_reference: int, n_query: int) -> int:
    """Smallest power of two >= max sequence length
    (tsalign/src/util.rs:30-33)."""
    n = max(n_reference, n_query, 1)
    m = 1
    while m < n:
        m *= 2
    return m


@dataclass(frozen=True)
class ChainPlan:
    """Config-derived planning data for one (k, max_n) bucket."""

    config_sha1: str
    k: int
    max_n: int
    window_radius: int  # TSM cross-cut reach bound (driver._window_radius)
    min_run: int  # minimum exact-match run length for a segment cut
    match_score: int  # chain DP: per matched char gain (cheapest mismatch)
    drift_unit: int  # chain DP: per unit of diagonal drift (cheapest extend)

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=1)

    @classmethod
    def from_json(cls, text: str) -> "ChainPlan":
        return cls(**json.loads(text))


def compute_plan(config: TemplateSwitchConfig, k: int, max_n: int) -> ChainPlan:
    from .driver import _window_radius

    table = config.primary_edit_costs
    n = table.substitution.shape[0]
    off_diag = table.substitution[~np.eye(n, dtype=bool)]
    finite = off_diag[off_diag < INF]
    match_score = max(1, int(finite.min())) if finite.size else 1
    ext = table.gap_extend[table.gap_extend < INF]
    drift_unit = max(1, int(ext.min())) if ext.size else 1
    return ChainPlan(
        config_sha1=config_digest(config),
        k=k,
        max_n=max_n,
        window_radius=_window_radius(config),
        min_run=2 * k + 8,
        match_score=match_score,
        drift_unit=drift_unit,
    )


def plan_cache_path(cache_directory: str, digest: str, k: int, max_n: int) -> str:
    return os.path.join(cache_directory, f"{digest}-{k}-{max_n}.tsc.json")


def load_or_create_plan(
    config: TemplateSwitchConfig,
    cache_directory: Optional[str],
    k: int,
    max_n: int,
    force_no_preprocessing: bool = False,
) -> ChainPlan:
    """Load the plan from the cache, else compute it (and store it when a
    cache directory is given).  `force_no_preprocessing` turns a cache miss
    into an error (a_star_chain_ts.rs:56-59)."""
    digest = config_digest(config)
    path = (
        plan_cache_path(cache_directory, digest, k, max_n)
        if cache_directory
        else None
    )
    if path and os.path.exists(path):
        with open(path) as f:
            plan = ChainPlan.from_json(f.read())
        # Consistency assertions on load (a_star_chain_ts.rs:52-53).
        if plan.config_sha1 != digest or plan.k != k or plan.max_n != max_n:
            raise PlanCacheError(
                f"preprocessing cache {path} does not match the configuration "
                f"(expected sha1={digest}, k={k}, max_n={max_n})"
            )
        return plan
    if force_no_preprocessing:
        raise PlanCacheError(
            "Forcing no preprocessing, but no cache file found"
            + (f" at {path}" if path else " (no cache directory given)")
        )
    plan = compute_plan(config, k, max_n)
    if path:
        os.makedirs(cache_directory, exist_ok=True)
        with open(path, "w") as f:
            f.write(plan.to_json())
    return plan
