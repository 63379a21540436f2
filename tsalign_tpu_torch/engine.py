"""Dense template-switch alignment engine on torch tensors.

Counterpart of ``tsalign_tpu/jax_engine.py::JaxAligner``, run as its host
rounds loop (``jax_engine.py:758-890``): a no-TS primary sweep over the
F = L + R + 1 flank layers, then rounds of per-kind reentry (module scan,
assembly, fold) and re-sweeps from the reentry seeds (which land in the
bottom flank layer), with the same exact stops: the k * delta bound, the TSLB improvement
test, the no-sweep stop on an unchanged reentry field, and the pruned-field
fixpoint.  Reentry runs on the chunked route: the live chunks come from the
same A + S liveness test as the JAX package, and where the JAX loop would take
its compact live-column route the port launches the chunks covering those
columns.  Per-round fields stay on the device; the traceback reads them
through ``fields.py`` views.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from .alignment import Alignment
from .config import TemplateSwitchConfig
from .costs import INF
from .fields import FieldView2, FieldView4
from .geometry import AlignmentRange
from .lower_bounds import compute_remaining_bound
from .numpy_engine import min_tsm_cost_bound
from .ops.common import (
    DEV_INF,
    from_device_costs,
    full_inf,
    validate_magnitudes,
)
from .ops.modules import KindModule, fold_kind_cells, kind_all_chunks
from .ops.primary import PrimarySweep
from .ops.primary_sweep import GAP_NONE
from .ops.tsm_modules import make_kind_spec, real_seq_length
from .chain.plan import config_digest
from .traceback import TracebackEngine

MAX_ROUNDS = 32

# Content-keyed memos for the remaining-cost bound and the kind modules.
_LB_MEMO: dict = {}
_KINDS_MEMO: dict = {}


def sweep_summary(M, rl: int, ql: int):
    """Entry layer (min over gaps of the top flank layer) and the target
    cell's values (``_summ_jit``)."""
    return M[-1].amin(dim=0), M[:, :, rl, ql].reshape(-1)


def accumulate(R_acc, R_new):
    """Fold a round's reentry field into the accumulator; also whether
    nothing improved (``_acc_jit``)."""
    R2 = torch.minimum(R_acc, R_new)
    return R2, bool(torch.equal(R2, R_acc))


def next_seeds(root, R):
    """Next sweep seeds: the root seeds min the reentry field at (layer
    index 0, GAP_NONE), the bottom flank layer -R (``_seeds_jit``)."""
    seeds = root.clone()
    seeds[0, GAP_NONE] = torch.minimum(seeds[0, GAP_NONE], R)
    return seeds


@dataclass
class EngineResult:
    cost: int
    rounds: int
    primary_fields: List = field(default_factory=list)
    reentry_fields: List = field(default_factory=list)


class TorchAligner:
    """The cost engine of the port (JaxAligner's host rounds loop)."""

    def __init__(
        self,
        config: TemplateSwitchConfig,
        reference: np.ndarray,
        query: np.ndarray,
        *,
        device,
        range_: Optional[AlignmentRange] = None,
        max_template_switches: Optional[int] = None,
        prune_range: bool = False,
        chunk: int = 64,
        allowed_primaries=(0, 1),
        allow_secondary_deletions: bool = True,
        keep_fields="device",
        use_lower_bounds: bool = True,
    ):
        """`keep_fields`: the per-round fields an `align` keeps for the
        traceback: "device" keeps ``fields.py`` views of the device tensors,
        True host int64 arrays, False none (a cost-only run).
        `use_lower_bounds`: False skips the remaining-cost bound (its value
        iteration on the host), which only prunes; the cost is exact either
        way."""
        self.device = torch.device(device)
        self.keep_fields = keep_fields
        self.use_lower_bounds = use_lower_bounds
        self.config = config
        self.allowed_primaries = tuple(allowed_primaries)
        self.ref = np.asarray(reference)
        self.qry = np.asarray(query)
        n_r, n_q = len(self.ref), len(self.qry)
        self.n_r, self.n_q = n_r, n_q
        # Real content lengths of possibly poison-padded inputs (bucketed
        # problems): every structural feasibility (seed walks, strict
        # reentry, the exit walk) derives from these; the padded lengths
        # only drive the shapes.
        self.n_r_real = real_seq_length(self.ref, config.alphabet.size)
        self.n_q_real = real_seq_length(self.qry, config.alphabet.size)
        self._padded = self.n_r_real != n_r or self.n_q_real != n_q
        self.range = range_ or AlignmentRange.complete(n_r, n_q)
        self.max_ts = max_template_switches
        self.prune_range = prune_range
        self.allow_sdel = allow_secondary_deletions
        self.chunk = chunk
        self.cells_swept = 0
        self._validate()
        if prune_range:
            self._sweep_range = self.range
            self.anti_bounds_ref = (self.range.reference_offset, self.range.reference_limit)
            self.anti_bounds_qry = (self.range.query_offset, self.range.query_limit)
        else:
            self._sweep_range = AlignmentRange.complete(n_r, n_q)
            self.anti_bounds_ref = (0, n_r)
            self.anti_bounds_qry = (0, n_q)
        self._sweeps: dict = {}  # allow_flank_climb -> PrimarySweep

    def _get_sweep(self, climb: bool) -> PrimarySweep:
        if climb not in self._sweeps:
            self._sweeps[climb] = PrimarySweep(
                self.config, self.ref, self.qry,
                range_=self._sweep_range, allow_flank_climb=climb,
            )
        return self._sweeps[climb]

    def _validate(self) -> None:
        cfg = self.config
        mx = 0
        for t in (
            cfg.primary_edit_costs,
            cfg.secondary_forward_edit_costs,
            cfg.secondary_reverse_edit_costs,
            cfg.left_flank_edit_costs,
            cfg.right_flank_edit_costs,
        ):
            for arr in (t.substitution, t.gap_open, t.gap_extend):
                finite = arr[arr < INF]
                if finite.size:
                    mx = max(mx, int(finite.max()))
        for fn in (
            cfg.rq_qr_offset_costs,
            cfg.rr_qq_offset_costs,
            cfg.length_costs,
            cfg.length_difference_costs,
            cfg.forward_anti_primary_gap_costs,
            cfg.reverse_anti_primary_gap_costs,
        ):
            finite = [c for _, c in fn.points if c < INF]
            if finite:
                mx = max(mx, max(finite))
        finite_base = [v for v in cfg.base_cost.values() if v < INF]
        mx = max(mx, max(finite_base) if finite_base else 0)
        validate_magnitudes(mx, 2 * (self.n_r + self.n_q + 2))

    def _root_seeds(self) -> torch.Tensor:
        cfg = self.config
        F = cfg.left_flank_length + cfg.right_flank_length + 1
        seeds = np.full((F, 3, self.n_r + 1, self.n_q + 1), DEV_INF, dtype=np.int32)
        seeds[
            cfg.right_flank_length,
            GAP_NONE,
            self.range.reference_offset,
            self.range.query_offset,
        ] = 0
        return torch.from_numpy(seeds).to(self.device)

    def _remaining_bound(self):
        """Admissible remaining-cost field (host numpy), memoized by content;
        None when the relaxed value iteration does not apply or is not
        asked for."""
        if not self.use_lower_bounds:
            return None
        if not hasattr(self, "_lb_cache"):
            key = (
                config_digest(self.config),
                self.ref.tobytes(),
                self.qry.tobytes(),
                self.range.reference_limit,
                self.range.query_limit,
            )
            if key not in _LB_MEMO:
                hit = compute_remaining_bound(
                    self.config, self.ref, self.qry,
                    self.range.reference_limit, self.range.query_limit,
                )
                _LB_MEMO.clear()
                _LB_MEMO[key] = hit
            self._lb_cache = _LB_MEMO[key]
        return self._lb_cache

    def _axes_can_rewind(self) -> tuple:
        neg_ag = any(
            fn.finite_window() is not None and fn.finite_window()[0] < 0
            for fn in (
                self.config.forward_anti_primary_gap_costs,
                self.config.reverse_anti_primary_gap_costs,
            )
        )
        return (
            neg_ag and 1 in self.allowed_primaries,
            neg_ag and 0 in self.allowed_primaries,
        )

    def _pruned_entry_cells(self, entry_cells: np.ndarray, best: int) -> np.ndarray:
        """Entry field with every cell that cannot start a TSM on an optimal
        or co-optimal path masked to DEV_INF (``JaxAligner._pruned_entry_cells``)."""
        A_cells = entry_cells.astype(np.int32).copy()
        ref_rewind, qry_rewind = self._axes_can_rewind()
        if not ref_rewind:
            A_cells[self.range.reference_limit + 1 :, :] = DEV_INF
        if not qry_rewind:
            A_cells[:, self.range.query_limit + 1 :] = DEV_INF
        lb = self._remaining_bound()
        if lb is not None:
            A64 = A_cells.astype(np.int64)
            useful = (A64 < DEV_INF // 2) & (lb.S < INF)
            if best < INF:
                useful &= A64 + lb.S <= best
            return np.where(useful, A_cells, np.int32(DEV_INF))
        if best >= INF:
            return A_cells
        thresh = self._entry_threshold(best)
        return np.where(A_cells.astype(np.int64) > thresh, np.int32(DEV_INF), A_cells)

    def _can_improve_cells(self, entry_cells: np.ndarray, best: int) -> bool:
        lb = self._remaining_bound()
        if lb is None or best >= INF:
            return True
        A64 = entry_cells.astype(np.int64)
        mask = (A64 < DEV_INF // 2) & (lb.S < INF)
        return bool(np.any(mask & (A64 + lb.S < best)))

    def _entry_threshold(self, best: int) -> int:
        slack = self.config.secondary_length_bonus * (self.n_r + self.n_q)
        delta = max(0, min_tsm_cost_bound(self.config))
        return best + slack - delta

    def _sdel_budget(self, upper_bound: int) -> Optional[int]:
        if upper_bound >= INF:
            return None
        steps = []
        for d in ("Forward", "Reverse"):
            t = self.config.secondary_edit_costs(d)
            steps.append(min(t.min_gap_open_cost(), t.min_gap_extend_cost()))
        min_step = min(steps)
        if min_step <= 0:
            return None
        budget = upper_bound // min_step
        b = 8
        while b < budget:
            b *= 2
        return b

    def _build_kinds(self, budget: Optional[int]) -> List[KindModule]:
        key = (
            config_digest(self.config),
            self.ref.tobytes(),
            self.qry.tobytes(),
            self.allowed_primaries,
            self.anti_bounds_ref,
            self.anti_bounds_qry,
            self.chunk,
            self.allow_sdel,
            budget,
        )
        if key in _KINDS_MEMO:
            return _KINDS_MEMO[key]
        kinds = []
        lut_cache = {}
        for pk in self.allowed_primaries:
            anti_lo, anti_hi = self.anti_bounds_qry if pk == 0 else self.anti_bounds_ref
            for sk in (0, 1):
                for dk in (0, 1):
                    spec = make_kind_spec(
                        self.config, self.n_r, self.n_q, pk, sk, dk, sdel_budget=budget,
                        n_ref_real=self.n_r_real if self._padded else None,
                        n_qry_real=self.n_q_real if self._padded else None,
                    )
                    if spec is None:
                        continue
                    km = KindModule(
                        spec, self.config, self.ref, self.qry, anti_lo, anti_hi,
                        chunk=self.chunk,
                        allow_secondary_deletions=self.allow_sdel,
                        lut_cache=lut_cache,
                    )
                    if km.active:
                        kinds.append(km)
        _KINDS_MEMO.clear()
        _KINDS_MEMO[key] = kinds
        return kinds

    def _chunk_bases(self, km: KindModule, A_mod, AS, best: int) -> List[int]:
        """Chunk bases of one kind, -1 for a chunk that cannot matter
        (``JaxAligner._reentry``'s liveness tests, ``jax_engine.py:506-557``)."""
        spec = km.spec
        C = km.chunk
        n_e = spec.n_anti + 1
        starts = range(0, n_e, C)
        if AS is not None:
            AS_mod = AS if spec.pk == 0 else AS.T
            e_live = np.nonzero(AS_mod.min(axis=0) <= best)[0]
            live = {min(int(e) // C * C, max(n_e - C, 0)) for e in e_live}
            bases = []
            for e0 in starts:
                eb = min(e0, n_e - C) if n_e >= C else 0
                bases.append(eb if (e0 // C * C) in live or eb in live else -1)
            return bases
        slack = self.config.secondary_length_bonus * (self.n_r + self.n_q)
        thresh = min(best + slack, DEV_INF)
        kind_min = max(spec.base, max(0, min_tsm_cost_bound(self.config)))
        bases = []
        for e0 in starts:
            eb = min(e0, n_e - C) if n_e >= C else 0
            a_min = int(A_mod[:, eb : eb + C].min()) if A_mod.size else DEV_INF
            bases.append(eb if a_min + kind_min <= thresh else -1)
        return bases

    def _entry_bound(self, A_cells: np.ndarray, best: int) -> Optional[np.ndarray]:
        """Entry cost plus the remaining bound of each entry cell (the
        chunk liveness test's AS), or None while no target cost is known."""
        lb = self._remaining_bound() if best < INF else None
        if lb is None:
            return None
        A64 = A_cells.astype(np.int64)
        return np.where((A64 < DEV_INF // 2) & (lb.S < INF), A64 + lb.S, INF)

    def _reentry(self, A_cells: np.ndarray, kinds: List[KindModule], best: int = INF):
        """Pruned entry field (host) + all kinds -> the folded reentry field,
        a device tensor (n_r+1, n_q+1)."""
        AS = self._entry_bound(A_cells, best)
        self.cells_swept += len(kinds) * (self.n_r + 1) * (self.n_q + 1)
        A_dev = {}
        R = full_inf((self.n_r + 1, self.n_q + 1), self.device)
        for km in kinds:
            spec = km.spec
            A_mod = A_cells if spec.pk == 0 else A_cells.T
            bases = self._chunk_bases(km, A_mod, AS, best)
            if all(b < 0 for b in bases):
                continue
            if spec.pk not in A_dev:
                A_dev[spec.pk] = torch.from_numpy(np.ascontiguousarray(A_mod)).to(self.device)
            PAD = max(0, -km.s_lo)
            width = PAD + spec.n_anti + 1 + max(0, km.chunk - 1 + km.s_hi)
            (Rk_pad,) = kind_all_chunks([km], A_dev[spec.pk][None], np.asarray([bases]),
                                        PAD, width)
            R = fold_kind_cells(
                R, Rk_pad, spec.n_anti_real, PAD=PAD, n_anti=spec.n_anti,
                transpose=spec.pk == 1,
            )
        return R

    def _sweep_summary(self, seeds: torch.Tensor, climb: bool):
        """Sweep from device seeds, left-flank climbs allowed when `climb`;
        returns (entry cells int32 host, target cost, M on the device)."""
        M = self._get_sweep(climb).sweep(seeds)
        self.cells_swept += M.shape[0] * 3 * (self.n_r + 1) * (self.n_q + 1)
        E, tv = sweep_summary(M, self.range.reference_limit, self.range.query_limit)
        t = int(tv.min())
        return E.cpu().numpy(), (INF if t >= DEV_INF // 2 else t), M

    def align(self) -> EngineResult:
        res = EngineResult(cost=INF, rounds=0)

        def keep(M, E):
            if self.keep_fields is True:
                res.primary_fields.append(from_device_costs(M.cpu().numpy()))
            elif self.keep_fields == "device":
                res.primary_fields.append(FieldView4(M, entry_cells=from_device_costs(E)))

        def keepR(R):
            if self.keep_fields is True:
                res.reentry_fields.append(from_device_costs(R.cpu().numpy()))
            elif self.keep_fields == "device":
                res.reentry_fields.append(FieldView2(R))

        root = self._root_seeds()
        t = self.max_ts
        if t is not None:
            E, best, M = self._sweep_summary(root, 0 < t)
            keep(M, E)
            if t == 0:
                res.cost, res.rounds = best, 1
                return res
            budget = self._sdel_budget(best)
            self._last_budget = budget
            kinds = self._build_kinds(budget)
            for c in range(1, t + 1):
                R = self._reentry(self._pruned_entry_cells(E, best), kinds, best=best)
                keepR(R)
                E, t_cost, M = self._sweep_summary(next_seeds(root, R), c < t)
                keep(M, E)
                best = min(best, t_cost)
            res.cost, res.rounds = best, t + 1
            return res

        E, best, M = self._sweep_summary(root, True)
        keep(M, E)
        delta = min_tsm_cost_bound(self.config)
        kinds = None
        A = None
        A_launched = None
        R_acc = None
        for k in range(1, MAX_ROUNDS + 1):
            if delta > 0 and k * delta > best:
                res.cost, res.rounds = best, k
                return res
            if not self._can_improve_cells(E, best):
                res.cost, res.rounds = best, k
                return res
            if kinds is None:
                budget = self._sdel_budget(best)
                self._last_budget = budget
                kinds = self._build_kinds(budget)
            if A is None:
                A = self._pruned_entry_cells(E, best)
            A_delta = A if A_launched is None else np.where(A < A_launched, A, np.int32(DEV_INF))
            R_new = self._reentry(A_delta, kinds, best=best)
            if R_acc is None:
                R_acc, unchanged = R_new, False
            else:
                R_acc, unchanged = accumulate(R_acc, R_new)
            A_launched = A if A_launched is None else np.minimum(A_launched, A)
            keepR(R_acc)
            if unchanged:
                res.cost, res.rounds = best, k + 1
                return res
            E_next, t_cost, M = self._sweep_summary(next_seeds(root, R_acc), True)
            keep(M, E_next)
            new_best = min(best, t_cost)
            A_next = self._pruned_entry_cells(E_next, new_best)
            if new_best < best:
                A = self._pruned_entry_cells(E, new_best)
            best = new_best
            if np.array_equal(A_next, A):
                res.cost, res.rounds = best, k + 1
                return res
            E = E_next
            A = A_next
        res.cost, res.rounds = best, MAX_ROUNDS + 1
        return res

    def align_with_traceback(self):
        result = self.align()
        self.last_rounds = result.rounds  # K-soundness guard (aligner)
        return align_with_traceback(self, result)


def align_with_traceback(aligner: TorchAligner, result: EngineResult):
    """Traceback of an engine result (``engine._align_with_traceback``)."""
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
        allowed_primaries=aligner.allowed_primaries,
    )
    return tb.trace(result.primary_fields, result.reentry_fields, climb_flags=climb)
