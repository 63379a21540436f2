"""Batched template-switch alignment: many pairs per device launch.

The corpus-level throughput path (the reference ran one pair per process
and left corpus parallelism to external scripts — alignment_result.rs:71-81,
SURVEY.md §2.8): pairs are padded to one poison-char bucket, their per-pair
tables stacked, and the single-pair kernels (ops/sweep, ops/module_scan) run
over the batch.  The rounds loop runs in
lockstep; each pair terminates by the same exact criteria as the single-pair
engines (k*delta bound, TSLB improvement test, pruned-entry fixpoint), and
the batch stops when every pair has.  Traceback runs on the host per pair
over the kept fields, so the full record pipeline (tie-break, extension,
equal-cost ranges, TOML) is available batched via `align_pairs`.

Chunk-level cost pruning is intentionally skipped here (it is per-pair,
data-dependent): this path trades it for batch parallelism.

This is the port's copy of ``tsalign_tpu/parallel/batch_ts.py``, its host
rounds loop (``BatchedTSAligner._align_host``, here `align`), with these
differences:

  * a `device` keyword: the per-round fields are torch tensors there, and
    the batched XLA programs (``_summ_batch_jit``, ``_seeds_batch_jit``,
    ``_fold_batch_jit``, ``_acc_batch_jit``) are batched plain torch; the
    summary reads each pair's target cell by a direct index;
  * the sweep of every pair is one launch of the sweep kernel with a pair
    axis (``_sweep_batch``, ``ops/sweep.py``); the same-sequence kinds'
    module scans one launch a kind of the module scan's diagonal mode with a
    pair axis (``_same_module_batch``); a kind's chunks one launch of the
    module scan a chunk index over the pairs for which that chunk is live
    (``ops.modules.kind_all_chunks``), the assembly pair by pair;
  * reentry takes the JAX batch's route per kind and round: the chunked
    route with per-pair live chunk bases, or the compact live-column route
    (``_kind_sel_map_jit``, here ``ops.modules.kind_sel_chunks``) when its
    power-of-two bucket is at most half the widest pair's live chunks; each
    kind's route of each round is appended to `route_log`;
  * `align` runs the fused rounds loop (`_align_fused`,
    ``parallel/fused_rounds.py``) where `fused` says so: by default on a
    CUDA device and not on the CPU, as the JAX package takes it off the
    CPU backend; otherwise the host loop (`_align_host`).  Its retry chain
    (for Mosaic compile rejections) and its catch-all are not ported: an
    exception in the fused loop propagates;
  * a mesh (``parallel/mesh.py``, axis "data"; `align`, `costs`,
    `align_with_traceback` and `align_pairs` take ``mesh=``) runs the host
    loop, as in the JAX package (``fused=True`` with a mesh raises
    ``ValueError``), with the compact route off.  The pair axis is split in
    contiguous blocks over the shards (``ValueError`` where the shard count
    does not divide it, as ``jax.device_put`` raises) for the launches only:
    the batched sweep, the diagonal-mode batch and each kind's chunks run a
    shard's pairs on the shard's device, and their results are gathered onto
    `device`, the mesh's first device.  The decisions (the shared budget,
    the rounds, the stop tests) stay on the one host loop, so a mesh changes
    no value, round or assembly call, only how the launches split;
  * not ported: the TPU workarounds (``sync_point``, the module kernel's
    compile-fallback retries, the masked-reduction summary, the bulk
    transfer of a single pair's kept fields);
  * kept fields: ``keep_fields=True`` keeps host int64 arrays, "device"
    keeps ``fields.py`` views of each pair's slice of the batched tensors;
  * `align_pairs` takes a `device` and falls back, on ``OverflowError``, to
    the port's single-pair ``Aligner``.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

import numpy as np
import torch

from .. import tracing
from ..config import TemplateSwitchConfig
from ..costs import INF
from ..engine import EngineResult
from ..fields import FieldView2, FieldView4
from ..geometry import AlignmentRange
from ..numpy_engine import count_rounds, kdelta_stop, min_tsm_cost_bound, rounds_stop_delta
from ..ops.common import (
    DEV_INF,
    device_key,
    from_device_costs,
    full_inf,
    to_device,
    to_device_costs,
    to_host,
    validate_magnitudes,
)
from ..ops.module_scan import module_scan_diag
from .. import engine as _engine
from ..ops.modules import (LEVEL_NAMES, KindModule, fold_kind_cells, kind_all_chunks,
                           kind_sel_chunks)
from ..ops.primary import PrimarySweep
from ..ops.primary_sweep import GAP_NONE
from ..ops.sweep import sweep_flanked, sweep_flankless
from ..ops.tsm_modules import make_kind_spec
from .mesh import shard_blocks


def _summ_batch(M_b, lr, lq):
    """Per-pair sweep summary: the entry layers (min over gaps of the top
    flank layer) and the target cells' values at each pair's limits."""
    B, F, G = M_b.shape[:3]
    E = M_b[:, -1].amin(dim=1)
    idx = torch.arange(B, device=M_b.device)
    tv = M_b[idx, :, :, lr, lq]
    return E, tv.reshape(B, F * G)


def _seeds_batch(root, R):
    """Next-round batched seeds (see engine.next_seeds)."""
    seeds = root.clone()
    seeds[:, 0, GAP_NONE] = torch.minimum(seeds[:, 0, GAP_NONE], R)
    return seeds


@tracing.spanned("engine.sweep")
def _sweep_batch(arrays, seeds, *, L, R):
    """The primary sweep of every pair in one launch of the sweep kernel's
    pair axis: seeds (B, F, 3, nr+1, nq+1) -> M of the same shape.  `arrays`
    are the pairs' stacked sweep tables (`_stack_sweep_arrays`)."""
    B, F, _, n_rows, Wq = seeds.shape
    # the pairs' plane-major fields, read and written in place (ops/primary.py)
    seeds_r = seeds.contiguous().view(B, F * 3, n_rows, Wq).permute(0, 2, 1, 3)
    tables, dd, io, ie = arrays
    if F == 1:
        M = sweep_flankless(tables, dd, seeds_r, io, ie)
    else:
        M = sweep_flanked(tables, dd, seeds_r, io, ie, L=L, R=R, climb=True)
    return M.permute(0, 2, 1, 3).reshape(B, F, 3, n_rows, Wq)


def _same_module_batch(kms, device):
    """The same-sequence module scan of one kind for every pair, in one
    launch of the module scan's diagonal mode with a pair axis; each pair's
    B_pre lands in its kind module's cache."""
    km0 = kms[0]
    ts = [km.tables(device) for km in kms]
    lvs = [km.level_tables(device) for km in kms]
    names = ("seed", "lut", "sdo", "sde")
    B = module_scan_diag(*(torch.stack([t[n] for t in ts]) for n in names),
                         *(torch.stack([lv[n] for lv in lvs]) for n in LEVEL_NAMES),
                         fwd=km0.dk == 0, allow_sdel=km0.allow_sdel)
    for i, km in enumerate(kms):
        km._b_pre[device_key(device)] = B[i]


def _acc_batch(R_acc, R_new):
    """Fold a round's reentry contributions into the accumulator and report
    whether anything improved (see engine.accumulate)."""
    R2 = torch.minimum(R_acc, R_new)
    return R2, bool(to_host((R2 == R_acc).all()))


class NotConvergedError(RuntimeError):
    """Not every pair of a batch converged within `max_rounds`."""


def _bucket(n: int) -> int:
    b = 64
    while b < n:
        b *= 2
    return b


# Content-keyed memos across BatchedTSAligner instances (the single-pair
# engine's _KINDS_MEMO/_LB_MEMO reasoning, engine.py): the per-pair
# remaining bounds, the kind modules (with their device tensors and the
# same-sequence module fields) and the stacked sweep arrays are pure
# functions of (config, padded pair bytes, ...), and rebuilding them
# dominated the warm batched wall (a fresh aligner instance per run is the
# natural API).  Each memo keeps a handful of entries, FIFO-evicted.
_BATCH_MEMO_CAP = 6
_BATCH_BOUNDS_MEMO: dict = {}
_BATCH_KINDS_MEMO: dict = {}
_BATCH_ARRAYS_MEMO: dict = {}
_BATCH_S32_MEMO: dict = {}


def _memo_put(memo: dict, key, value) -> None:
    while len(memo) >= _BATCH_MEMO_CAP:
        memo.pop(next(iter(memo)))
    memo[key] = value


class BatchedTSAligner:
    """Batched TS alignment over equal-bucket pairs (costs + traceback)."""

    def __init__(
        self,
        config: TemplateSwitchConfig,
        pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
        max_rounds: int = 32,
        chunk: int = 64,
        keep_fields: bool = False,
        ranges: Optional[Sequence[AlignmentRange]] = None,
        use_lower_bounds: bool = True,
        bucket: bool = True,
        *,
        device,
        fused: Optional[bool] = None,
    ):
        """`ranges`: optional per-pair focus ranges (chained-mode segments
        align a focus window inside radius context, chain/driver.py): the
        root seed sits at each pair's (reference_offset, query_offset) and
        the target at its limits; the primary roams the whole padded grid
        (NoPrune semantics, as the single-pair segment path).  `device`:
        where the fields live and the kernels run ("cuda" or "cpu").
        `fused`: run the fused rounds loop (True) or the host loop (False);
        None takes the fused loop on a CUDA device and the host loop on the
        CPU; under a mesh the host loop runs, and True raises."""
        self.device = torch.device(device)
        self.fused = self.device.type == "cuda" if fused is None else bool(fused)
        self._fused_asked = fused
        self.config = config
        self.use_lower_bounds = use_lower_bounds
        self.n_pairs = len(pairs)
        P = config.alphabet.size
        # bucket=False: exact shapes — no power-of-two padding overhead when
        # there is nothing to share.
        nr = max(len(r) for r, _ in pairs)
        nq = max(len(q) for _, q in pairs)
        if bucket:
            nr, nq = _bucket(nr), _bucket(nq)
        self.nr, self.nq = nr, nq
        # REAL content lengths, poison-aware: callers may hand in arrays
        # already padded with the poison char (chained-mode buckets), and
        # every structural feasibility (seed walks, strict reentry, exit
        # walk) must derive from the real lengths (padded soundness;
        # tests/test_padded_soundness.py).
        from ..ops.tsm_modules import real_seq_length

        self.real = [
            (
                real_seq_length(np.asarray(r), P),
                real_seq_length(np.asarray(q), P),
            )
            for r, q in pairs
        ]
        self.ranges = (
            list(ranges)
            if ranges is not None
            else [AlignmentRange.complete(lr, lq) for lr, lq in self.real]
        )
        self.limits = [
            (rg.reference_limit, rg.query_limit) for rg in self.ranges
        ]
        self.refs = np.full((self.n_pairs, nr), P, dtype=np.int8)
        self.qrys = np.full((self.n_pairs, nq), P, dtype=np.int8)
        for i, (r, q) in enumerate(pairs):
            self.refs[i, : len(r)] = r
            self.qrys[i, : len(q)] = q
        self.max_rounds = max_rounds
        self.chunk = chunk
        self.keep_fields = keep_fields
        self._validate()

        # Per-pair single-pair sweep machinery (host precompute per pair),
        # with identical statics across the batch thanks to the shared
        # bucket.  Kind modules are built lazily (the deletion-drift budget
        # needs round-0 costs, engine._sdel_budget).
        self.sweeps = [
            PrimarySweep(config, self.refs[i], self.qrys[i])
            for i in range(self.n_pairs)
        ]
        self.kind_sets: Optional[List[List[KindModule]]] = None
        self.sdel_budget: Optional[int] = None
        # One entry a kind and reentry round, as engine.TorchAligner's, with
        # "e_sel" (each pair's gathered columns) for the compact route.
        self.route_log: List[dict] = []
        self._reentries = 0

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
        base_fin = [v for v in cfg.base_cost.values() if v < INF]
        if base_fin:
            mx = max(mx, max(base_fin))
        validate_magnitudes(mx, 2 * (self.nr + self.nq + 2))

    # ---- per-pair exact-termination machinery (mirrors jax_engine) ----

    def _bounds(self):
        """Per-pair admissible remaining-cost bounds (lower_bounds.py);
        None entries mean the relaxed iteration does not apply for that
        pair's padded grid."""
        if not self.use_lower_bounds:
            return [None] * self.n_pairs  # see engine.DenseAligner
        if not hasattr(self, "_lb_cache"):
            from ..chain.plan import config_digest
            from ..lower_bounds import compute_remaining_bound

            key = (
                config_digest(self.config),
                self.refs.tobytes(),
                self.qrys.tobytes(),
                tuple(self.real),
                tuple(self.limits),
            )
            if key not in _BATCH_BOUNDS_MEMO:
                bounds = [
                    compute_remaining_bound(
                        self.config, self.refs[i], self.qrys[i], rl, ql
                    )
                    for i, (rl, ql) in enumerate(self.limits)
                ]
                _memo_put(_BATCH_BOUNDS_MEMO, key, bounds)
            self._lb_cache = _BATCH_BOUNDS_MEMO[key]
        return self._lb_cache

    def _pruned_entry_pair(self, i: int, E_i: np.ndarray, best: int) -> np.ndarray:
        """Per-pair pruned entry field in device int32 from the entry layer
        (see engine.TorchAligner._pruned_entry_cells; padded cells beyond
        the pair's real lengths are unreachable through poison moves, so no
        extra slice masking is needed)."""
        A_cells = E_i.astype(np.int32)
        lb = self._bounds()[i]
        if lb is not None:
            A64 = A_cells.astype(np.int64)
            useful = (A64 < int(DEV_INF) // 2) & (lb.S < INF)
            if best < INF:
                useful &= A64 + lb.S <= best
            return np.where(useful, A_cells, np.int32(DEV_INF))
        if best >= INF:
            return A_cells
        slack = self.config.secondary_length_bonus * (self.nr + self.nq)
        thresh = best + slack - max(0, min_tsm_cost_bound(self.config))
        return np.where(
            A_cells.astype(np.int64) > thresh, np.int32(DEV_INF), A_cells
        )

    def _bounds_device(self):
        """Device (S32, has_lb) of the per-pair remaining bounds for the
        fused loop: clamped int32 (finite values stay below the device's
        infinite threshold, as a lower bound may only shrink; host INF maps
        to DEV_INF, so the S == INF prune stays), memoised under `_bounds`'
        content key."""
        from ..chain.plan import config_digest

        key = (
            config_digest(self.config),
            self.refs.tobytes(),
            self.qrys.tobytes(),
            tuple(self.real),
            tuple(self.limits),
            self.use_lower_bounds,
            str(self.device),
        )
        if key not in _BATCH_S32_MEMO:
            BIG = int(DEV_INF) // 2
            S32 = np.full((self.n_pairs, self.nr + 1, self.nq + 1), int(DEV_INF), np.int32)
            has_lb = np.zeros(self.n_pairs, bool)
            for i, lb in enumerate(self._bounds()):
                if lb is None:
                    continue
                has_lb[i] = True
                S = np.minimum(lb.S, BIG - 1).astype(np.int32)
                S32[i] = np.where(lb.S >= INF, np.int32(DEV_INF), S)
            _memo_put(_BATCH_S32_MEMO, key, (to_device(S32, self.device),
                                             to_device(has_lb, self.device)))
        return _BATCH_S32_MEMO[key]

    def _can_improve_pair(self, i: int, E_i: np.ndarray, best: int) -> bool:
        lb = self._bounds()[i]
        if lb is None or best >= INF:
            return True
        A64 = E_i.astype(np.int64)
        mask = (A64 < int(DEV_INF) // 2) & (lb.S < INF)
        return bool(np.any(mask & (A64 + lb.S < best)))

    def _derive_budget(self, best: List[int]) -> Optional[int]:
        finite = [b for b in best if b < INF]
        if not finite:
            return None
        cfg = self.config
        steps = []
        for d in ("Forward", "Reverse"):
            t = cfg.secondary_edit_costs(d)
            steps.append(min(t.min_gap_open_cost(), t.min_gap_extend_cost()))
        min_step = min(steps)
        if min_step <= 0:
            return None
        budget = max(finite) // min_step
        b = 8
        while b < budget:
            b *= 2
        return b

    def _blocks(self, mesh):
        """[(slice of the pairs, device)] of the launches: one block on
        `device` without a mesh, else each shard's contiguous block of pairs
        over ``mesh["data"]`` on its device."""
        if mesh is None:
            return [(slice(None), self.device)]
        if device_key(mesh.devices[0]) != device_key(self.device):
            raise ValueError(f"the mesh's first device {mesh.devices[0]} is not the "
                             f"aligner's device {self.device}")
        return shard_blocks(mesh, self.n_pairs, "data")

    def _build_kind_sets(self, budget: Optional[int], mesh=None) -> None:
        from ..chain.plan import config_digest

        key = (
            config_digest(self.config),
            self.refs.tobytes(),
            self.qrys.tobytes(),
            tuple(self.real),
            self.chunk,
            budget,
        )
        if key in _BATCH_KINDS_MEMO:
            self.sdel_budget = budget
            self.kind_sets, self._kind_state = _BATCH_KINDS_MEMO[key]
        else:
            self._build_kind_sets_uncached(budget)
            _memo_put(_BATCH_KINDS_MEMO, key, (self.kind_sets, self._kind_state))
        # The intra-sequence kinds' module fields, on this device: one launch
        # of the diagonal mode a kind, over every pair (a shard's pairs on its
        # device under a mesh).
        for km0, kms, _ in self._kind_state:
            if not km0.spec.same_seq:
                continue
            for sl, dev in self._blocks(mesh):
                if any(device_key(dev) not in km._b_pre for km in kms[sl]):
                    _same_module_batch(kms[sl], dev)

    def _build_kind_sets_uncached(self, budget: Optional[int]) -> None:
        self.sdel_budget = budget
        self.kind_sets = []
        for i in range(self.n_pairs):
            kinds = []
            # Per-PAIR LUT cache (shared across the pk variants only): the
            # LUTs embed the pair's secondary sequence, so sharing across
            # pairs would price every pair with pair 0's sequences.
            lut_cache: dict = {}
            lr, lq = self.real[i]
            for pk in (0, 1):
                for sk in (0, 1):
                    for dk in (0, 1):
                        # Per-pair REAL lengths drive the structural
                        # feasibilities (seed walk bounds, strict reentry,
                        # exit walk); the shared bucket lengths drive the
                        # shapes and the active/None decision, so every
                        # pair agrees on the kind set and the stacked
                        # shapes below.
                        spec = make_kind_spec(
                            self.config,
                            self.nr,
                            self.nq,
                            pk,
                            sk,
                            dk,
                            sdel_budget=budget,
                            n_ref_real=lr,
                            n_qry_real=lq,
                        )
                        if spec is None:
                            continue
                        km = KindModule(
                            spec,
                            self.config,
                            self.refs[i],
                            self.qrys[i],
                            0,
                            self.nq if pk == 0 else self.nr,
                            chunk=self.chunk,
                            lut_cache=lut_cache,
                        )
                        if km.active:
                            kinds.append(km)
            self.kind_sets.append(kinds)
        # Round-invariant per-kind batch state: the kind's module of every
        # pair and its chunk bases.
        self._kind_state = []
        kind_count = len(self.kind_sets[0]) if self.kind_sets else 0
        for ki in range(kind_count):
            kms = [ks[ki] for ks in self.kind_sets]
            km0 = kms[0]
            n_e = km0.spec.n_anti + 1
            C = km0.chunk
            e_bases = [
                min(e0, n_e - C) if n_e >= C else 0 for e0 in range(0, n_e, C)
            ]
            self._kind_state.append((km0, kms, e_bases))

    def _reentry_batch(self, A_stack: np.ndarray, mesh=None) -> torch.Tensor:
        """Batched all-kinds reentry cells from the stacked (pruned) entry
        fields; under a mesh each kind takes the chunked route, a shard's
        pairs on its device."""
        B = self.n_pairs
        self._reentries += 1
        R_dev = full_inf((B, self.nr + 1, self.nq + 1), self.device)
        a_dev = {}  # pk -> the entry fields of every pair, in the kind's orientation
        for km0, kms, e_bases in self._kind_state:
            spec = km0.spec
            A_mod = A_stack if spec.pk == 0 else A_stack.transpose(0, 2, 1)
            n_anti = spec.n_anti
            C = km0.chunk
            PAD = max(0, -km0.s_lo)
            width = PAD + n_anti + 1 + max(0, C - 1 + km0.s_hi)
            # Per-pair chunk liveness: the pruned entry field marks dead
            # cells DEV_INF, so a chunk whose column block has no finite
            # entry contributes nothing — its base becomes the -1 sentinel
            # (kind_all_chunks skips it), so each pair scans only its own
            # live chunks; after round 1 the pruned field is sparse and this
            # is the batch analog of the single-pair chunk pruning.
            eb_b = np.full((B, len(e_bases)), -1, np.int32)
            finite = A_mod < int(DEV_INF) // 2  # (B, n_p+1, n_e)
            col_live = finite.any(axis=1)  # (B, n_e)
            for ci, eb in enumerate(e_bases):
                live = col_live[:, eb : eb + C].any(axis=1)
                eb_b[live, ci] = eb
            if (eb_b < 0).all():
                continue  # no pair has a live entry for this kind
            # Compact-column route (the single-pair engine's post-round-1
            # fast path): once the pruned entry fields are sparse but
            # scattered, whole chunks stay live while only a handful of
            # columns in them matter — gather just the live columns per
            # pair into a shared power-of-two bucket instead, taken on a
            # clear win only (the JAX batch's rule, ``batch_ts.py:527-535``
            # of ``tsalign_tpu/parallel``).  Sentinel slots (0)
            # re-gather column 0 (a duplicate or pruned-INF) — exact either
            # way.
            n_live = col_live.sum(axis=1)
            Kb = C
            while Kb < max(int(n_live.max()), 1):
                Kb *= 2
            live_chunks_max = int((eb_b >= 0).sum(axis=1).max())
            with tracing.span("rounds.reentry"):
                if spec.pk not in a_dev:
                    a_dev[spec.pk] = to_device(A_mod, self.device)
                log = {"round": self._reentries, "kind": (spec.pk, spec.sk, spec.dk)}
                if mesh is None and _engine._COMPACT_ROUTE and 2 * Kb <= live_chunks_max * C:
                    e_sel_b = np.zeros((B, Kb), np.int64)
                    for i in range(B):
                        idx = np.nonzero(col_live[i])[0]
                        e_sel_b[i, : idx.size] = idx
                    OUTW = PAD + n_anti + 1 + max(0, km0.s_hi)
                    slabs = kind_sel_chunks(kms, a_dev[spec.pk], e_sel_b, PAD, OUTW,
                                            n_live=n_live)
                    log.update(route="compact", Kb=Kb,
                               e_sel=tuple(tuple(int(e) for e in row) for row in e_sel_b))
                else:
                    slabs = []
                    for sl, dev in self._blocks(mesh):
                        slabs += [None if x is None else x.to(self.device)
                                  for x in kind_all_chunks(kms[sl], a_dev[spec.pk][sl].to(dev),
                                                           eb_b[sl], PAD, width)]
                    log.update(route="chunked", chunks=int((eb_b >= 0).sum()))
                self.route_log.append(log)
                for i, Rk_pad in enumerate(slabs):
                    if Rk_pad is None:
                        continue
                    lr, lq = self.real[i]
                    R_dev[i] = fold_kind_cells(
                        R_dev[i], Rk_pad, lq if spec.pk == 0 else lr,
                        PAD=PAD, n_anti=n_anti, transpose=spec.pk == 1,
                    )
        return R_dev

    def _stack_sweep_arrays(self):
        """The pairs' sweep tables on the device, stacked on a leading pair
        axis (the flankless or the flanked layout of ``ops/primary.py``)."""
        from ..chain.plan import config_digest

        memo_key = (
            config_digest(self.config),
            self.refs.tobytes(),
            self.qrys.tobytes(),
            str(self.device),
        )
        if memo_key in _BATCH_ARRAYS_MEMO:
            return _BATCH_ARRAYS_MEMO[memo_key]
        per_pair = [s._inputs_on(self.device) for s in self.sweeps]
        out = tuple(torch.stack(xs) for xs in zip(*per_pair))
        _memo_put(_BATCH_ARRAYS_MEMO, memo_key, out)
        return out

    @tracing.spanned("engine.seeds")
    def _root_seeds(self) -> torch.Tensor:
        """(B, F, 3, nr+1, nq+1) root seeds: 0 at each pair's origin in flank
        layer R's GAP_NONE plane (R the right flank's length), DEV_INF
        elsewhere."""
        F = self.config.left_flank_length + self.config.right_flank_length + 1
        seeds0 = np.full((self.n_pairs, F, 3, self.nr + 1, self.nq + 1), INF, dtype=np.int64)
        for i, rg in enumerate(self.ranges):
            seeds0[
                i, self.config.right_flank_length, GAP_NONE,
                rg.reference_offset, rg.query_offset,
            ] = 0
        return to_device(to_device_costs(seeds0), self.device)

    def align(self, mesh=None) -> List[EngineResult]:
        """Per-pair engine results (exact optimum each), batch-lockstep: the
        fused rounds loop when `fused`, else the host rounds loop; under a
        `mesh` (``parallel/mesh.py``, axis "data") the host rounds loop with
        the pairs' launches split over its shards."""
        if mesh is not None:
            if self._fused_asked:
                raise ValueError("fused=True takes no mesh: a mesh runs the host rounds loop")
            results = self._align_host(mesh)
        else:
            results = self._align_fused() if self.fused else self._align_host()
        count_rounds(results)
        return results

    def _stop_deltas(self) -> List[int]:
        """Each pair's k * delta stop value (``numpy_engine.rounds_stop_delta``
        at its real lengths)."""
        return [rounds_stop_delta(self.config, lr, lq) for lr, lq in self.real]

    def _align_fused(self) -> List[EngineResult]:
        """The rounds loop with its stop algebra on the device
        (``_align_fused``; ``parallel/fused_rounds.py``)."""
        from . import fused_rounds

        B = self.n_pairs
        keep = bool(self.keep_fields)
        arrays_b = self._stack_sweep_arrays()
        root = self._root_seeds()
        L, R = self.config.left_flank_length, self.config.right_flank_length
        # each pair's limits and k * delta stop value (from its real
        # lengths, which a range's limits may be shorter than) in one upload
        stop = self._stop_deltas()
        lr, lq, stop_dev = to_device(
            [[r for r, _ in self.limits], [q for _, q in self.limits],
             [min(d, int(DEV_INF)) for d in stop]], self.device)
        M0 = _sweep_batch(arrays_b, root, L=L, R=R)
        with tracing.span("engine.summary"):
            E0, t0 = fused_rounds._summ(M0, lr, lq)
            t0_host = to_host(t0)
            best0 = [INF if int(t) >= int(DEV_INF) // 2 else int(t) for t in t0_host]
        results = [EngineResult(cost=INF, rounds=1) for _ in range(B)]

        # Every pair already provably done at round 1 (the k * delta bound
        # or the TSLB improvement stop): no kinds, no bounds on the device.
        delta = min_tsm_cost_bound(self.config)
        if all(b < INF for b in best0):
            E0_host = to_host(E0)
            kd = [kdelta_stop(1, stop[i], best0[i]) for i in range(B)]
            if all(kd[i] or not self._can_improve_pair(i, E0_host[i], best0[i])
                   for i in range(B)):
                for i in range(B):
                    results[i].cost = best0[i]
                    results[i].kdelta_stop = kd[i]
                self._keep_fused_fields(results, [M0], [], [E0], np.ones(B, np.int32),
                                        np.zeros(B, np.int32))
                return results

        if self.kind_sets is None:
            self._build_kind_sets(self._derive_budget(best0))
        S32, has_lb = self._bounds_device()
        data = dict(root=root, arrays=arrays_b, S32=S32, has_lb=has_lb, lr=lr, lq=lq, E0=E0,
                    M0=M0, best0=torch.where(t0 >= DEV_INF // 2, DEV_INF, t0))
        meta = dict(delta=delta, stop=stop_dev,
                    slack=self.config.secondary_length_bonus * (self.nr + self.nq),
                    max_rounds=self.max_rounds, keep=keep, L=L, R=R)
        out = fused_rounds.fused_loop(self, data, meta)
        if not bool(to_host(out["done"].all())):
            raise NotConvergedError(
                f"BatchedTSAligner: not all pairs converged within "
                f"max_rounds={self.max_rounds}"
            )
        best = to_host(out["best"])
        rounds, kd = to_host(torch.stack((out["rounds"], out["kdelta"].to(out["rounds"].dtype))))
        for i in range(B):
            results[i].cost = INF if int(best[i]) >= int(DEV_INF) // 2 else int(best[i])
            results[i].rounds = int(rounds[i])
            results[i].kdelta_stop = bool(kd[i])
        self._keep_fused_fields(results, out["M_all"], out["R_all"], out["E_all"],
                                to_host(out["np_cnt"]), to_host(out["nr_cnt"]))
        return results

    def _keep_fused_fields(self, results, M_all, R_all, E_all, np_cnt, nr_cnt):
        """Each pair's kept fields from the fused loop's rounds: done is
        monotone, so pair i's are the first np_cnt[i] primary and nr_cnt[i]
        reentry rounds (``_keep_fused_fields``).  The entry layers are read
        to the host here, after the loop."""
        if not self.keep_fields:
            return
        for i, res in enumerate(results):
            for r in range(int(np_cnt[i])):
                if self.keep_fields is True:
                    res.primary_fields.append(from_device_costs(to_host(M_all[r][i])))
                else:
                    entry = from_device_costs(to_host(E_all[r][i]))
                    res.primary_fields.append(FieldView4(M_all[r][i], entry_cells=entry))
            for r in range(int(nr_cnt[i])):
                res.reentry_fields.append(
                    from_device_costs(to_host(R_all[r][i]))
                    if self.keep_fields is True else FieldView2(R_all[r][i]))

    def _align_host(self, mesh=None) -> List[EngineResult]:
        """The host rounds loop (``_align_host``), its launches split over
        the shards of `mesh` when one is given."""
        B = self.n_pairs
        blocks = self._blocks(mesh)

        arrays_b = self._stack_sweep_arrays()

        def sweep_v(seeds):
            parts = [_sweep_batch(
                tuple(a[sl].to(dev) for a in arrays_b),
                seeds[sl].to(dev),
                L=self.config.left_flank_length,
                R=self.config.right_flank_length,
            ) for sl, dev in blocks]
            return parts[0] if len(parts) == 1 else torch.cat([p.to(self.device) for p in parts])

        seeds = self._root_seeds()

        lr_idx = to_device([r for r, _ in self.limits], self.device)
        lq_idx = to_device([q for _, q in self.limits], self.device)

        def summarize(M_dev):
            """(entry layers (B, nr+1, nq+1) host, per-pair target costs)."""
            with tracing.span("engine.summary"):
                E_b, tv_b = _summ_batch(M_dev, lr_idx, lq_idx)
                tv = to_host(tv_b)
                costs = [
                    INF if int(t.min()) >= int(DEV_INF) // 2 else int(t.min())
                    for t in tv
                ]
                return to_host(E_b), costs

        logger.debug("batch phase: initial sweep (B=%d nr=%d nq=%d)", B, self.nr, self.nq)
        M_dev = sweep_v(seeds)
        E_host, best = summarize(M_dev)
        logger.debug("batch phase: initial sweep done")
        results = [EngineResult(cost=INF, rounds=1) for _ in range(B)]

        def keep_primary(M_dev_round, E_round, live=None):
            """Append this round's primary field per live pair: host copies
            (keep_fields=True) or lazy views of the pair's slice of the
            device tensor ("device" mode, fields.py)."""
            if self.keep_fields is True:
                M_host = to_host(M_dev_round)
                for i in range(B):
                    if live is None or live[i]:
                        results[i].primary_fields.append(
                            from_device_costs(M_host[i])
                        )
            elif self.keep_fields == "device":
                for i in range(B):
                    if live is None or live[i]:
                        results[i].primary_fields.append(
                            FieldView4(
                                M_dev_round[i],
                                entry_cells=from_device_costs(E_round[i]),
                            )
                        )

        def keep_reentry(R_dev_round, live):
            if self.keep_fields is True:
                R_host = to_host(R_dev_round)
                for i in range(B):
                    if live[i]:
                        results[i].reentry_fields.append(
                            from_device_costs(R_host[i])
                        )
            elif self.keep_fields == "device":
                for i in range(B):
                    if live[i]:
                        results[i].reentry_fields.append(
                            FieldView2(R_dev_round[i])
                        )

        if self.keep_fields:
            keep_primary(M_dev, E_host)
        stop = self._stop_deltas()
        root_dev = seeds

        done = [False] * B
        A_cur: List[Optional[np.ndarray]] = [None] * B
        # Delta-incremental reentry (see engine.TorchAligner.align): the
        # reentry field is a device-resident running min of per-launch
        # contributions, and a cell is relaunched only when its entry value
        # improved since its last launch — confirmation rounds launch
        # (almost) nothing.  Exactness argument as in the single-pair loop.
        A_launched: List[Optional[np.ndarray]] = [None] * B
        R_acc = None
        for k in range(1, self.max_rounds + 1):
            for i in range(B):
                if done[i]:
                    continue
                if kdelta_stop(k, stop[i], best[i]):
                    done[i], results[i].rounds = True, k
                    results[i].kdelta_stop = True
                # TSLB improvement stop.
                elif not self._can_improve_pair(i, E_host[i], best[i]):
                    done[i], results[i].rounds = True, k
            if all(done):
                break
            if self.kind_sets is None:
                logger.debug("batch phase: build_kind_sets (round %d)", k)
                self._build_kind_sets(self._derive_budget(best), mesh)
            for i in range(B):
                if A_cur[i] is None:
                    if done[i]:
                        # Converged before any reentry (k*delta bound or
                        # TSLB improvement stop in this same round): its one
                        # and only delta launch must be inert, not a full
                        # pruned-entry launch for a pair already proven done.
                        A_cur[i] = np.full(
                            (self.nr + 1, self.nq + 1), DEV_INF, np.int32
                        )
                    else:
                        A_cur[i] = self._pruned_entry_pair(
                            i, E_host[i], best[i]
                        )
            A_delta = []
            for i in range(B):
                a = A_cur[i]
                if A_launched[i] is None:
                    A_delta.append(a)
                    A_launched[i] = a
                else:
                    A_delta.append(
                        np.where(a < A_launched[i], a, np.int32(DEV_INF))
                    )
                    A_launched[i] = np.minimum(A_launched[i], a)
            A_stack = np.stack(A_delta)
            logger.debug("batch phase: reentry (round %d)", k)
            R_new = self._reentry_batch(A_stack, mesh)
            if R_acc is None:
                R_acc, unchanged = R_new, False
            else:
                R_acc, unchanged = _acc_batch(R_acc, R_new)
            logger.debug("batch phase: reentry done (round %d)", k)
            if self.keep_fields:
                keep_reentry(R_acc, [not d for d in done])
            # Exact no-sweep stop: this round's launches left the reentry
            # accumulator unchanged, so seeds, sweeps and pruned entry
            # fields would all repeat — a fixpoint for every live pair.
            if unchanged:
                for i in range(B):
                    if not done[i]:
                        done[i], results[i].rounds = True, k + 1
                break
            sk_dev = _seeds_batch(root_dev, R_acc)
            logger.debug("batch phase: re-sweep (round %d)", k)
            M_next_dev = sweep_v(sk_dev)
            E_next, t_costs = summarize(M_next_dev)
            new_best = [min(a, b) for a, b in zip(best, t_costs)]
            if self.keep_fields:
                keep_primary(M_next_dev, E_next, live=[not d for d in done])
            # Pruned-entry fixpoint per pair (engine semantics): once
            # the pruned field is stable, reentries/seeds/sweeps repeat.
            for i in range(B):
                if done[i]:
                    continue
                A_next_i = self._pruned_entry_pair(i, E_next[i], new_best[i])
                A_i = A_cur[i]
                if new_best[i] < best[i]:
                    A_i = self._pruned_entry_pair(i, E_host[i], new_best[i])
                if np.array_equal(A_next_i, A_i):
                    done[i], results[i].rounds = True, k + 1
                    A_cur[i] = A_next_i
                else:
                    A_cur[i] = A_next_i
            best = new_best
            E_host = E_next
        else:
            raise NotConvergedError(
                f"BatchedTSAligner: not all pairs converged within "
                f"max_rounds={self.max_rounds}"
            )
        for i in range(B):
            results[i].cost = best[i]
        return results

    def costs(self, mesh=None) -> np.ndarray:
        """Optimal TS alignment cost per pair (int64, INF when unreachable)."""
        return np.asarray(
            [r.cost for r in self.align(mesh=mesh)], dtype=np.int64
        )

    def align_with_traceback(self, mesh=None):
        """[(cost, Alignment)] per pair: batched rounds on device, host
        traceback per pair over the kept fields (traceback.py)."""
        from ..alignment import Alignment
        from ..traceback import TracebackEngine

        if not self.keep_fields:
            # Lazy device views by default: the stacked per-round fields
            # stay on the device and each pair's traceback fetches only the
            # row blocks its path touches (fields.py).
            self.keep_fields = "device"
        results = self.align(mesh=mesh)
        self.last_results = results  # per-pair rounds (K-soundness guard)
        out = []
        for i, res in enumerate(results):
            if res.cost >= INF:
                out.append((INF, Alignment([])))
                continue
            tb = TracebackEngine(
                self.config,
                self.refs[i],
                self.qrys[i],
                range_=self.ranges[i],
                prune_range=False,
                sdel_budget=self.sdel_budget,
            )
            out.append(
                tb.trace(
                    res.primary_fields,
                    res.reentry_fields,
                    climb_flags=[True] * len(res.primary_fields),
                )
            )
        return out

def align_pairs(
    config: TemplateSwitchConfig,
    pairs: Sequence[Tuple[str, str]],
    names: Optional[Sequence[Tuple[str, str]]] = None,
    maximise_total_length: bool = True,
    chunk: int = 64,
    *,
    device,
    on_batch=None,
    fused: Optional[bool] = None,
    mesh=None,
):
    """Full batched record pipeline: align many (reference, query) string
    pairs in one batch and return a list of AlignmentResult records (the
    same post-processing as Aligner.align: K-scaled total-length tie-break,
    extension, equal-cost ranges, reference-schema TOML), on `device`.
    `on_batch(indices, aligner)`, when given, is called after each batch's
    traceback with the pairs' input indices and its BatchedTSAligner (whose
    ``last_results`` hold each pair's rounds).  `fused` picks the rounds
    loop of the batches and of the single-pair fallbacks (`BatchedTSAligner`);
    `mesh` (axis "data", its first device `device`) splits each batch's
    launches over its shards.

    Falls back to the exact single-pair path per pair when the K-scaled
    algebra would overflow the device int32 domain.
    """
    with tracing.span("facade.call"):
        return _align_pairs(config, pairs, names, maximise_total_length, chunk, device=device,
                            on_batch=on_batch, fused=fused, mesh=mesh)


def _align_pairs(config, pairs, names, maximise_total_length, chunk, *, device, on_batch,
                 fused, mesh):
    import time as _time

    from ..aligner import Aligner
    from ..postprocess import compute_ts_equal_cost_ranges
    from ..result import AlignmentResult, AStarResultInfo

    al = config.alphabet
    enc = [(al.encode(r.upper()), al.encode(q.upper())) for r, q in pairs]
    # Multi-bucket grouping: pairs bucket to the power-of-two of their own
    # lengths, so short pairs don't pay the longest pair's padded grid
    # (poison-padding soundness makes every bucket exact).  Each group runs
    # the lockstep batch below; records are reassembled in input order.
    groups: dict = {}
    for i, (r, q) in enumerate(enc):
        groups.setdefault((_bucket(len(r)), _bucket(len(q))), []).append(i)
    # Sub-batch cap: the kept fields scale with rounds * B * bucket^2 in
    # device memory, so large groups split into batches of <= 8.
    only_key = next(iter(groups))
    if len(groups) > 1 or len(groups[only_key]) > 8:
        records = [None] * len(pairs)
        for _key, idxs in sorted(groups.items()):
            for c0 in range(0, len(idxs), 8):
                part = idxs[c0 : c0 + 8]
                sub = _align_pairs(
                    config,
                    [pairs[i] for i in part],
                    names=[names[i] for i in part] if names else None,
                    maximise_total_length=maximise_total_length,
                    chunk=chunk,
                    device=device,
                    fused=fused,
                    mesh=mesh,
                    on_batch=None if on_batch is None else (
                        lambda idx, bt, part=part: on_batch([part[j] for j in idx], bt)),
                )
                for i, rec in zip(part, sub):
                    records[i] = rec
        return records
    # K-soundness (aligner._run_engine): the scaled decomposition is exact
    # only while total TS length < K; a rewinding config with zero-cost TSMs
    # makes the maximise objective unbounded, so drop the tie-break there.
    if (
        maximise_total_length
        and config.can_rewind()
        and min_tsm_cost_bound(config) <= 0
    ):
        maximise_total_length = False
    K = 1
    cfg_run = config
    if maximise_total_length:
        nr = _bucket(max(len(r) for r, _ in enc))
        nq = _bucket(max(len(q) for _, q in enc))
        while K < nr + nq + 2:
            K *= 2
        cfg_run = config.scaled_for_length_tiebreak(K)

    t0 = _time.monotonic()
    try:
        bt = BatchedTSAligner(cfg_run, enc, chunk=chunk, keep_fields="device",
                              device=device, fused=fused)
        traced = bt.align_with_traceback(mesh=mesh)
        if on_batch is not None:
            on_batch(list(range(len(pairs))), bt)
    except OverflowError:
        # Scaled magnitudes exceed the int32 device domain: single-pair
        # exact fallback (the facade's own int64 fallback).
        a = Aligner(costs=config, device=device, fused=fused)
        out = []
        for i, (r, q) in enumerate(pairs):
            nm = names[i] if names else ("reference", "query")
            out.append(a.align(r, q, nm[0], nm[1]).result)
        return out

    duration = _time.monotonic() - t0
    # Post-hoc K check per pair (aligner._run_engine's proof): with
    # rewinding reentries a record is the lexicographic optimum where its
    # own total TS length is below K; the others re-run through the
    # single-pair guarded path (which escalates K exactly).
    redo: List[int] = []
    if K > 1 and config.can_rewind():
        redo = [i for i, (comp, aln) in enumerate(traced)
                if comp < INF and aln.ts_total_length() >= K]
    if redo:
        a = Aligner(costs=config, device=device, fused=fused)
        for i in redo:
            nm = names[i] if names else ("reference", "query")
            comp_i, aln_i = a._run_engine(
                enc[i][0], enc[i][1],
                AlignmentRange.complete(len(enc[i][0]), len(enc[i][1])),
                None, (0, 1), False,
            )
            traced[i] = (comp_i * K if comp_i < INF else INF, aln_i)
    records = []
    for i, (comp, alignment) in enumerate(traced):
        r_str, q_str = pairs[i][0].upper(), pairs[i][1].upper()
        ref_arr, qry_arr = enc[i]
        nm = names[i] if names else ("reference", "query")
        rng = AlignmentRange.complete(len(ref_arr), len(qry_arr))
        if comp >= INF:
            cost = INF
            alignment = None
            result = AStarResultInfo(type="NoTarget")
        else:
            cost = -(-comp // K)
            compute_ts_equal_cost_ranges(alignment, config, ref_arr, qry_arr, rng)
            result = AStarResultInfo(type="FoundTarget", cost=cost)
        cells = (len(ref_arr) + 1) * (len(qry_arr) + 1)
        records.append(
            AlignmentResult.new(
                alignment=alignment,
                reference=r_str,
                query=q_str,
                reference_rc=al.reverse_complement_str(r_str),
                query_rc=al.reverse_complement_str(q_str),
                reference_name=nm[0],
                query_name=nm[1],
                reference_offset=0,
                query_offset=0,
                result=result,
                duration_seconds=duration / max(len(pairs), 1),
                opened_nodes=cells,
                closed_nodes=cells,
                suboptimal_opened_nodes=0,
            )
        )
    return records
