"""Dense template-switch alignment engine (numpy reference implementation).

Replaces the reference's best-first search (generic_a_star + lib_tsalign
template_switch_distance) with an iterated dense DP:

  round 0:  flank-layered gap-affine primary sweep from the root
  round k:  extract the flank-L entry field from round k-1, run the dense
            TSM module sweeps (ops/tsm_modules.py) to produce a reentry
            field, and re-sweep the primary layers with the reentry seeds.

Round k covers all alignments with at most k template switches (exactly k
when a maximum TS count stratifies the rounds); costs are monotone
non-increasing across rounds and integer-valued, so iterating to a fixpoint
is exact.  This is the wavefront formulation the JAX/Pallas device engine
implements; this numpy version is its executable spec, validated against the
Dijkstra oracle (oracle.py).

Semantics preserved from the reference:
  * flank-climb edges are gated on "can start another template switch"
    (context.rs:225-331), so with a finite max TS count the rounds are
    stratified by exact count;
  * the target accepts any flank/gap state at the range limits
    (context.rs:731-748);
  * under the default NoPrune range strategy only the root and target use
    the range; primary steps roam the full sequences (primary_range.rs).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from . import tracing
from .config import TemplateSwitchConfig
from .costs import INF
from .geometry import AlignmentRange
from .ops.primary_sweep import GAP_NONE, PrimarySweep
from .ops.tsm_modules import compute_reentry_fields, real_seq_length

_DK = ("Forward", "Reverse")


@dataclass
class EngineResult:
    cost: int
    rounds: int
    # Per-round primary fields (F, 3, n_r+1, n_q+1) and reentry seed fields
    # (n_r+1, n_q+1); kept for traceback.
    primary_fields: List[np.ndarray] = field(default_factory=list)
    reentry_fields: List[np.ndarray] = field(default_factory=list)
    kdelta_stop: bool = False  # the k * delta stop ended the rounds loop


class DenseAligner:
    """Dense counterpart of the oracle's template-switch Dijkstra."""

    def __init__(
        self,
        config: TemplateSwitchConfig,
        reference: np.ndarray,
        query: np.ndarray,
        range_: Optional[AlignmentRange] = None,
        max_template_switches: Optional[int] = None,
        prune_range: bool = False,
        allow_secondary_deletions: bool = True,
        max_rounds: int = 32,
        allowed_primaries=(0, 1),
        use_lower_bounds: bool = True,
    ):
        self.config = config
        self.allowed_primaries = tuple(allowed_primaries)
        self.ref = np.asarray(reference)
        self.qry = np.asarray(query)
        n_r, n_q = len(self.ref), len(self.qry)
        self.range = range_ or AlignmentRange.complete(n_r, n_q)
        self.max_ts = max_template_switches
        self.prune_range = prune_range
        self.allow_sdel = allow_secondary_deletions
        self.max_rounds = max_rounds
        # use_lower_bounds=False skips the TSLB value iteration entirely
        # (exact either way — pruning falls back to the global thresholds):
        # on SMALL problems (chained-mode verification probes) the bound
        # costs more to build than it saves (~1.3 s vs sub-second sweeps,
        # 91% of a profiled chain_align wall).
        self.use_lower_bounds = use_lower_bounds

        if prune_range:
            sweep_range = self.range
            self.anti_bounds_ref = (self.range.reference_offset, self.range.reference_limit)
            self.anti_bounds_qry = (self.range.query_offset, self.range.query_limit)
        else:
            # NoPrune walks are bounded by the REAL sequence ends — poison
            # padding (bucketed batch/chain problems) must not widen the
            # anti-gap walk space (context.rs:636-707 semantics).
            from .ops.tsm_modules import real_seq_length

            sweep_range = AlignmentRange.complete(n_r, n_q)
            self.anti_bounds_ref = (
                0, real_seq_length(self.ref, config.alphabet.size)
            )
            self.anti_bounds_qry = (
                0, real_seq_length(self.qry, config.alphabet.size)
            )
        self._sweep_range = sweep_range

    def _sweep(self, seeds: np.ndarray, climb: bool) -> np.ndarray:
        sweep = PrimarySweep(
            self.config,
            self.ref,
            self.qry,
            range_=self._sweep_range,
            allow_flank_climb=climb,
        )
        F = self.config.left_flank_length + self.config.right_flank_length + 1
        self.cells_swept = getattr(self, "cells_swept", 0) + F * 3 * (
            (len(self.ref) + 1) * (len(self.qry) + 1)
        )
        return sweep.sweep(seeds)

    def _root_seeds(self) -> np.ndarray:
        cfg = self.config
        F = cfg.left_flank_length + cfg.right_flank_length + 1
        seeds = np.full((F, 3, len(self.ref) + 1, len(self.qry) + 1), INF, dtype=np.int64)
        seeds[
            cfg.right_flank_length,  # layer_index(flank 0)
            GAP_NONE,
            self.range.reference_offset,
            self.range.query_offset,
        ] = 0
        return seeds

    def _target_cost(self, M: np.ndarray) -> int:
        return int(M[:, :, self.range.reference_limit, self.range.query_limit].min())

    def _entry_field(self, M: np.ndarray) -> np.ndarray:
        """Flank-L layer, min over gap types (TS entrances gate on flank == L,
        context.rs:357-374)."""
        return M[-1].min(axis=0)

    def _sdel_budget(self, upper_bound: int) -> Optional[int]:
        if upper_bound >= INF:
            return None
        cfg = self.config
        steps = []
        for d in _DK:
            t = cfg.secondary_edit_costs(d)
            steps.append(min(t.min_gap_open_cost(), t.min_gap_extend_cost()))
        min_step = min(steps)
        if min_step <= 0:
            return None
        return upper_bound // min_step

    def _reentry(
        self, A: np.ndarray, budget: Optional[int], best: int = INF
    ) -> np.ndarray:
        """Reentry field from a (possibly TSLB-pruned) entry field `A`.

        Feeding the pruned field is exact: a masked cell provably cannot
        start a TSM on any optimal or co-optimal path (see `_pruned_entry`),
        and the cross-kind module sweep compacts to the live cells, so
        pruning directly shrinks the dominant per-round work."""
        if not hasattr(self, "_module_cache"):
            self._module_cache = {}
        lb = self._remaining_bound() if best < INF else None
        # Work accounting (surfaced as opened_nodes: DP cells computed).
        self.cells_swept = getattr(self, "cells_swept", 0) + 8 * (
            (len(self.ref) + 1) * (len(self.qry) + 1)
        )
        return compute_reentry_fields(
            self.config,
            self.ref,
            self.qry,
            A,
            self.anti_bounds_ref,
            self.anti_bounds_qry,
            landing_bound=lb.B if lb is not None else None,
            best=best,
            sdel_budget=budget,
            allow_secondary_deletions=self.allow_sdel,
            allowed_primaries=self.allowed_primaries,
            cache=self._module_cache,
        )

    def align(self) -> EngineResult:
        result = self._align()
        count_rounds([result])
        return result

    def _align(self) -> EngineResult:
        cfg = self.config
        F = cfg.left_flank_length + cfg.right_flank_length + 1
        root = self._root_seeds()
        t = self.max_ts

        if t is not None:
            # Stratified by exact TS count: V_c uses entries from V_{c-1};
            # flank climbs allowed only while another TS can start (c < t).
            results = EngineResult(cost=INF, rounds=0)
            M = self._sweep(root, climb=(0 < t))
            results.primary_fields.append(M)
            best = self._target_cost(M)
            budget = self._sdel_budget(best)
            self._last_budget = budget
            for c in range(1, t + 1):
                R = self._reentry(self._pruned_entry(M, best), budget, best=best)
                results.reentry_fields.append(R)
                seeds = np.full_like(root, INF)
                seeds[0, GAP_NONE] = R  # layer_index(-right_flank_length) = 0
                seeds = np.minimum(seeds, root)
                M = self._sweep(seeds, climb=(c < t))
                results.primary_fields.append(M)
                best = min(best, self._target_cost(M))
            results.cost = best
            results.rounds = t + 1
            return results

        # Unlimited TS count: accumulate reentry seeds to a fixpoint.
        results = EngineResult(cost=INF, rounds=0)
        M = self._sweep(root, climb=True)
        results.primary_fields.append(M)
        best = self._target_cost(M)
        budget = self._sdel_budget(best)
        self._last_budget = budget
        delta = rounds_stop_delta(
            cfg,
            real_seq_length(self.ref, cfg.alphabet.size),
            real_seq_length(self.qry, cfg.alphabet.size),
        )
        A = None
        for k in range(1, self.max_rounds + 1):
            if kdelta_stop(k, delta, best):
                results.cost = best
                results.rounds = k
                results.kdelta_stop = True
                return results
            # TSLB improvement stop: no entry cell can start a further TSM
            # and still strictly beat the incumbent.
            if not self._can_improve(M, best):
                results.cost = best
                results.rounds = k
                return results
            if A is None:
                A = self._pruned_entry(M, best)
            R_prev = (
                results.reentry_fields[-1] if results.reentry_fields else None
            )
            R = self._reentry(A, budget, best=best)
            results.reentry_fields.append(R)
            # Exact no-sweep stop (mirrors jax_engine): an unchanged reentry
            # field means unchanged seeds, so the sweep would reproduce M
            # and the pruned entry field verbatim — a fixpoint.
            if R_prev is not None and np.array_equal(R, R_prev):
                results.cost = best
                results.rounds = k + 1
                return results
            seeds = np.minimum(root, _as_seeds(R, F))
            M_next = self._sweep(seeds, climb=True)
            results.primary_fields.append(M_next)
            new_best = min(best, self._target_cost(M_next))
            # TSLB stop (lower_bounds.py): the next reentry depends only on
            # the pruned entry field (cells that could start a TSM on an
            # optimal or co-optimal path).  Once that field is stable,
            # reentries, seeds and sweeps all repeat — a true fixpoint of
            # the target-equivalent pruned system.
            A_next = self._pruned_entry(M_next, new_best)
            if new_best < best:
                A = self._pruned_entry(M, new_best)
            best = new_best
            if np.array_equal(A_next, A):
                results.cost = best
                results.rounds = k + 1
                return results
            M = M_next
            A = A_next
        results.cost = best
        results.rounds = self.max_rounds + 1
        return results

    def _remaining_bound(self):
        """Admissible remaining-cost field (TSLB counterpart; ref
        lower_bounds/template_switch.rs:75-284), or None when the relaxed
        value iteration does not apply (zero-cost-TSM configs)."""
        from .lower_bounds import compute_remaining_bound

        if not self.use_lower_bounds:
            return None
        if not hasattr(self, "_lb_cache"):
            self._lb_cache = compute_remaining_bound(
                self.config,
                self.ref,
                self.qry,
                self.range.reference_limit,
                self.range.query_limit,
            )
        return self._lb_cache

    def _pruned_entry(self, M: np.ndarray, best: int) -> np.ndarray:
        """Entry field with every cell that cannot start a TSM on an optimal
        or co-optimal path masked to INF.

        S is the one-TSM start-here-and-finish bound of the full-grid
        relaxed fixpoint, so S == INF proves no TSM started at the cell can
        ever reach the target (sound for ranged NoPrune runs where a path
        may overshoot a limit and template-switch back).  With an incumbent,
        A + S > best additionally excludes the cell from optimal and
        co-optimal paths.  Fallback when the relaxed iteration does not
        apply: the global one-TSM delta threshold (see
        jax_engine._entry_threshold)."""
        A = self._entry_field(M)
        lb = self._remaining_bound()
        if lb is not None:
            useful = (A < INF) & (lb.S < INF)
            if best < INF:
                useful &= A + lb.S <= best
            return np.where(useful, A, INF)
        if best >= INF:
            return A
        slack = self.config.secondary_length_bonus * (len(self.ref) + len(self.qry))
        thresh = best + slack - max(0, min_tsm_cost_bound(self.config))
        return np.where(A > thresh, INF, A)

    def _can_improve(self, M: np.ndarray, best: int) -> bool:
        """TSLB improvement test (the reference's frontier-pruning role,
        lower_bounds/template_switch.rs:75-284): any path with more TSMs
        than the completed rounds enters its next TSM from a value in M's
        entry field, costing at least A + S.  If no cell has A + S < best,
        no further round can beat the incumbent — equal-cost paths cannot
        change the reported optimum (the total-length tie-break is already
        internal to the comp algebra, so a tie-break-better path has
        strictly smaller comp and keeps a strict cell alive)."""
        lb = self._remaining_bound()
        if lb is None or best >= INF:
            return True
        A = self._entry_field(M)
        mask = (A < INF) & (lb.S < INF)
        return bool(np.any(mask & (A + lb.S < best)))

    def align_with_traceback(self):
        result = self.align()
        self.last_rounds = result.rounds
        return _align_with_traceback(self, result)


def _align_with_traceback(aligner, result):
    """Shared traceback wrapper for DenseAligner / JaxAligner results."""
    from .alignment import Alignment
    from .traceback import TracebackEngine

    if result.cost >= INF:
        return result.cost, Alignment([])
    t = aligner.max_ts
    if t is not None:
        climb = [c < t for c in range(len(result.primary_fields))]
    else:
        climb = [True] * len(result.primary_fields)
    tb = TracebackEngine(
        aligner.config,
        aligner.ref,
        aligner.qry,
        range_=aligner.range,
        prune_range=aligner.prune_range,
        allow_secondary_deletions=aligner.allow_sdel,
        sdel_budget=getattr(aligner, "_last_budget", None),
        allowed_primaries=getattr(aligner, "allowed_primaries", (0, 1)),
    )
    return tb.trace(result.primary_fields, result.reentry_fields, climb_flags=climb)


def _as_seeds(R: np.ndarray, F: int) -> np.ndarray:
    seeds = np.full((F, 3) + R.shape, INF, dtype=np.int64)
    seeds[0, GAP_NONE] = R
    return seeds


def align_cost(
    config: TemplateSwitchConfig,
    reference: np.ndarray,
    query: np.ndarray,
    **kwargs,
) -> int:
    """Convenience: optimal template-switch alignment cost."""
    return DenseAligner(config, reference, query, **kwargs).align().cost


def _min_tsm_cost(config) -> int:
    """Least cost of one template switch with no length bonus: min base +
    min offset + min length + min ldiff + min anti over the enabled kinds
    (INF when none is)."""
    def fmin(fn):
        vals = [c for _, c in fn.points if c < INF]
        return min(vals) if vals else INF

    best = INF
    for key, base in config.base_cost.items():
        if base >= INF:
            continue
        same = key[0] == key[1]
        off = fmin(config.rr_qq_offset_costs if same else config.rq_qr_offset_costs)
        d = fmin(config.anti_primary_gap_costs("Forward" if key[2] == "f" else "Reverse"))
        total = base + off + fmin(config.length_costs) + fmin(
            config.length_difference_costs
        ) + d
        best = min(best, total)
    return best


def min_tsm_cost_bound(config) -> int:
    """Safe lower bound on the total extra cost of one template switch:
    min base + min offset + min length + min ldiff + min anti, minus the
    maximum possible secondary-length discount when the tie-break bonus is
    active and the length cost caps the length.  Where it does not (the
    default config), nothing is subtracted: the value is then a cost with
    no bonus, which the pruning thresholds pair with a slack of their own;
    the rounds loops stop on `rounds_stop_delta` instead."""
    best = _min_tsm_cost(config)
    if best >= INF:
        return INF
    lmax = config.length_costs.maximum_finite_input()
    lmax = int(lmax) if lmax is not None else 0
    return max(0, best - config.secondary_length_bonus * lmax)


def rounds_stop_delta(config, n_r: int, n_q: int) -> int:
    """The least extra value one more template switch adds to a path of the
    pair (n_r, n_q), for the rounds loops' exact stop: a path that round k
    could still improve has k template switches, so once k * delta exceeds
    the incumbent the loop is done.  0 disables the stop.

    Proof of the bound.  A template switch costs at least `_min_tsm_cost`,
    less `secondary_length_bonus` for each primary character it consumes
    (its secondary matches, substitutions and insertions: the length that
    the length cost is charged on).  Those characters are consecutive
    characters of one of the two sequences, so there are at most
    max(n_r, n_q) of them, and where the length cost has a finite largest
    input l_max, at most l_max."""
    best = _min_tsm_cost(config)
    if best >= INF:
        return INF
    n = max(n_r, n_q)
    l_max = config.length_costs.maximum_finite_input()
    if l_max is not None:
        n = min(n, int(l_max))
    return max(0, best - config.secondary_length_bonus * n)


def kdelta_stop(k, delta, best):
    """Whether the k * delta stop ends a rounds loop at the top of round k:
    every path round k could still add has k template switches, each worth
    at least `delta` (`rounds_stop_delta`), so none beats the incumbent
    `best` once k * delta > best.  Python ints, or tensors of one value a
    pair (the fused loop)."""
    return (delta > 0) & (k * delta > best)


def count_rounds(results) -> None:
    """Counts each engine result's rounds (`rounds.rounds`) and whether the
    k * delta stop ended its loop (`rounds.kdelta_stops`, 1 or 0) while
    tracing is on."""
    if not tracing.enabled:
        return
    for r in results:
        tracing.count("rounds.rounds", int(r.rounds))
        tracing.count("rounds.kdelta_stops", int(r.kdelta_stop))
