"""High-level aligner facade and Python API.

Mirrors the reference's `Aligner` facade (lib_tsalign/src/a_star_aligner/
configurable_a_star_align.rs:120-373) and its pyo3 bindings
(python_bindings/src/lib.rs:59-152): a serde-style settings object plus
`align(reference, query, ...)` returning a result with `cigar()`, `stats()`
and the op list.

Strategy mapping to the dense engine:
  * template_switch_min_length_strategy (none/lookahead/preprocessed/
    preprocessed-lookahead) and template_switch_chaining_strategy
    (none/precompute-only/lower-bound) are A* pruning accelerators in the
    reference; they do not change the optimum (the reference test suite
    asserts that, lib_tsalign/src/tests.rs:38-194).  The dense engine
    computes the same optimum without them, so they are accepted and
    ignored.
  * no_ts -> max_template_switches = 0.
  * descendant strategy `only-equal` -> all TSMs must share a primary
    (descendant) sequence: solved exactly by running the engine once per
    allowed primary and taking the better result.
  * cost_limit -> the result becomes WithoutTarget/ExceededCostLimit when
    the optimum exceeds the limit (generic_a_star/src/lib.rs:370-380).
  * memory_limit is accepted for CLI parity; the dense engine's memory is
    deterministic (no search frontier), so it never trips.

This is the port's copy of ``tsalign_tpu/aligner.py``.  It differs in the
engine choice only.  The `engine` setting takes ``"device"`` (the default)
or ``"numpy"``; no value picks the engine by sequence length, so no pair
leaves the device unless the caller asks.  Under ``"device"``, `device` is
a required setting and ``_run_engine_raw`` runs ``engine.TorchAligner`` on
it whatever the sequence length and, on an ``OverflowError`` from the int32
algebra, the exact int64 numpy engine (``numpy_engine.DenseAligner``).  The
`fused` setting goes to ``TorchAligner``: its rounds loop, fused (True) or on
the host (False), None by the device.
Under ``"numpy"`` it runs that numpy engine alone.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .alignment import Alignment
from .alphabet import Alphabet, get_alphabet
from .config import TemplateSwitchConfig
from .costs import INF
from .engine import TorchAligner
from .geometry import AlignmentRange
from .numpy_engine import DenseAligner, min_tsm_cost_bound
from .result import AlignmentResult, AStarResultInfo

import logging

logger = logging.getLogger(__name__)


@dataclass
class Aligner:
    """Configurable aligner facade (reference parity:
    configurable_a_star_align.rs:120-131)."""

    costs: Optional[TemplateSwitchConfig] = None
    alphabet: str = "dna-n"
    template_switch_min_length_strategy: str = "lookahead"  # accepted, ignored
    template_switch_chaining_strategy: str = "none"  # accepted, ignored
    template_switch_total_length_strategy: str = "maximise"  # tie-break via K-scaled algebra (_run_engine)
    template_switch_descendant_strategy: str = "any"  # any | only-equal
    no_ts: bool = False
    force_label_correcting: bool = False  # accepted, ignored (dense is exact)
    engine: str = "device"  # device | numpy
    chunk: int = 64
    device: Optional[str] = None  # required by the device engine: "cuda", "cpu", ...
    fused: Optional[bool] = None  # the rounds loop: fused (True), host (False), None by device

    def __post_init__(self):
        if self.engine not in ("device", "numpy"):
            raise ValueError(f"Aligner: engine must be 'device' or 'numpy', not {self.engine!r}")
        if self.engine == "device" and self.device is None:
            raise ValueError("Aligner needs an explicit device, e.g. device='cuda'")
        if self.costs is None:
            self.costs = TemplateSwitchConfig.default(get_alphabet(self.alphabet))

    def set_costs_parse(self, text: str) -> None:
        self.costs = TemplateSwitchConfig.parse_plain(text, get_alphabet(self.alphabet))

    def _estimate_memory(self, n_r: int, n_q: int) -> int:
        """Approximate peak working-set bytes of the dense engine: primary
        field layers + per-kind module planes (counterpart of the
        reference's approximate node-memory accounting, generic_a_star
        lib.rs:333-335 — ours is field-shaped, not node-count-shaped)."""
        cfg = self.costs
        F = cfg.left_flank_length + cfg.right_flank_length + 1
        cells = (n_r + 1) * (n_q + 1)
        field = F * 3 * cells * 4  # int32 device layers
        width = 1
        for fn in (cfg.rq_qr_offset_costs, cfg.rr_qq_offset_costs):
            w = fn.finite_window()
            if w is not None:
                width = max(width, int(min(w[1], 2**31)) - int(w[0]) + 1)
        lmax = cfg.length_costs.maximum_finite_input()
        L = int(lmax) if lmax is not None else 1
        kinds = 8
        module = kinds * self.chunk * width * max(L, 1) * 4
        return 3 * field + module

    def _run_engine(
        self,
        ref_arr,
        qry_arr,
        range_,
        max_ts,
        allowed_primaries,
        prune_range: bool,
    ) -> Tuple[int, Alignment]:
        """Returns (cost, alignment).  Under the maximise total-length
        tie-break (the reference CLI default, align.rs:115-117) the engines
        run on a K-scaled config with secondary_length_bonus = 1, so path
        values are K*cost - ts_total_length; minimizing that is the
        lexicographic (cost, -ts_total_length) optimum.

        K-soundness: the decomposition is exact iff every path the engine
        represents has ts_total_length < K.  Without rewinding reentries
        (config.can_rewind() False) the discounted ops consume monotone
        primary positions, so tsl <= n_r + n_q < K.  With rewind, tsl is
        bounded by (#TSMs) * l_max <= (rounds - 1) * l_max, checked
        post-hoc; on violation K is escalated and the engine re-run.
        Degenerate configs (rewind + possibly-zero-cost TSMs) make the
        maximise objective unbounded — the reference's label-correcting
        search would not terminate there — so the tie-break is dropped and
        the raw optimum returned."""
        maximise = self.template_switch_total_length_strategy == "maximise"
        base_cfg = self.costs
        rewind = base_cfg.can_rewind()
        if (
            maximise
            and max_ts != 0
            and rewind
            and min_tsm_cost_bound(base_cfg) <= 0
        ):
            maximise = False
        K = 1
        if maximise:
            while K < len(ref_arr) + len(qry_arr) + 2:
                K *= 2
        n_max = max(len(ref_arr), len(qry_arr), 1)
        lw = base_cfg.length_costs.maximum_finite_input()
        l_max_eff = min(int(lw) if lw is not None else n_max, n_max)
        for _ in range(4):
            cfg = (
                base_cfg.scaled_for_length_tiebreak(K) if K > 1 else base_cfg
            )
            comp, alignment = self._run_engine_raw(
                cfg, ref_arr, qry_arr, range_, max_ts, allowed_primaries,
                prune_range,
            )
            if comp >= INF:
                return INF, alignment
            if K == 1:
                return comp, alignment
            t_bound = max(0, getattr(self, "_last_rounds", 1) - 1) * l_max_eff
            if not rewind or max_ts == 0 or t_bound < K:
                return -(-comp // K), alignment
            while K <= t_bound:
                K *= 2
        # Escalation did not settle (pathological); the raw optimum is exact.
        comp, alignment = self._run_engine_raw(
            base_cfg, ref_arr, qry_arr, range_, max_ts, allowed_primaries,
            prune_range,
        )
        return comp, alignment

    def _run_engine_raw(
        self,
        cfg,
        ref_arr,
        qry_arr,
        range_,
        max_ts,
        allowed_primaries,
        prune_range: bool,
    ) -> Tuple[int, Alignment]:
        kw = dict(
            range_=range_,
            max_template_switches=max_ts,
            prune_range=prune_range,
            allowed_primaries=allowed_primaries,
        )
        if self.engine == "device":
            try:
                # The per-round fields stay on the device; the traceback
                # fetches row blocks on demand (fields.py).
                eng = TorchAligner(
                    cfg, ref_arr, qry_arr, device=self.device, chunk=self.chunk,
                    fused=self.fused, **kw
                )
                out = eng.align_with_traceback()
                self._last_cells = getattr(self, "_last_cells", 0) + eng.cells_swept
                self._last_rounds = getattr(eng, "last_rounds", 1)
                return out
            except OverflowError:
                pass  # fall back to the exact int64 numpy engine
        eng = DenseAligner(cfg, ref_arr, qry_arr, **kw)
        out = eng.align_with_traceback()
        self._last_cells = getattr(self, "_last_cells", 0) + getattr(
            eng, "cells_swept", 0
        )
        self._last_rounds = getattr(eng, "last_rounds", 1)
        return out

    def align(
        self,
        reference: str,
        query: str,
        reference_name: str = "reference",
        query_name: str = "query",
        range_: Optional[AlignmentRange] = None,
        cost_limit: Optional[int] = None,
        memory_limit: Optional[int] = None,
        max_template_switches: Optional[int] = None,
        prune_range: bool = False,
        extend_beyond_range: bool = True,
    ) -> "TSPairwiseAlignment":
        al = self.costs.alphabet
        ref_arr = al.encode(reference.upper())
        qry_arr = al.encode(query.upper())
        max_ts = 0 if self.no_ts else max_template_switches

        if memory_limit is not None:
            est = self._estimate_memory(len(ref_arr), len(qry_arr))
            if est > memory_limit:
                rng0 = range_ or AlignmentRange.complete(len(ref_arr), len(qry_arr))
                return TSPairwiseAlignment(
                    AlignmentResult.new(
                        alignment=None,
                        reference=reference.upper(),
                        query=query.upper(),
                        reference_rc=al.reverse_complement_str(reference.upper()),
                        query_rc=al.reverse_complement_str(query.upper()),
                        reference_name=reference_name,
                        query_name=query_name,
                        reference_offset=rng0.reference_offset,
                        query_offset=rng0.query_offset,
                        # max_cost = highest cost expanded before aborting;
                        # the refusal is up-front, so nothing was searched
                        result=AStarResultInfo(
                            type="ExceededMemoryLimit", max_cost=0
                        ),
                        duration_seconds=0.0,
                        opened_nodes=0,
                        closed_nodes=0,
                        suboptimal_opened_nodes=0,
                    )
                )

        t0 = time.monotonic()
        self._last_cells = 0  # DP-cell work accumulated by _run_engine_raw
        if self.template_switch_descendant_strategy == "only-equal" and (
            max_ts is None or max_ts > 0
        ):
            best = (INF, Alignment([]))
            for pk in (0, 1):
                c, a = self._run_engine(
                    ref_arr, qry_arr, range_, max_ts, (pk,), prune_range
                )
                if c < best[0]:
                    best = (c, a)
            cost, alignment = best
        else:
            cost, alignment = self._run_engine(
                ref_arr, qry_arr, range_, max_ts, (0, 1), prune_range
            )
        duration = time.monotonic() - t0

        rng = range_ or AlignmentRange.complete(len(ref_arr), len(qry_arr))
        if cost < INF and alignment is not None:
            from .postprocess import compute_ts_equal_cost_ranges, extend_beyond_range as _ext

            if extend_beyond_range:
                rng = _ext(alignment, self.costs, ref_arr, qry_arr, rng)
            compute_ts_equal_cost_ranges(alignment, self.costs, ref_arr, qry_arr, rng)
        if cost >= INF:
            result = AStarResultInfo(type="NoTarget")
            alignment = None
        elif cost_limit is not None and cost > cost_limit:
            result = AStarResultInfo(type="ExceededCostLimit", cost_limit=cost_limit)
            alignment = None
        else:
            result = AStarResultInfo(type="FoundTarget", cost=cost)

        # Honest work accounting in the reference's statistics slots:
        # opened_nodes = DP cells computed (sweep layers x rounds + module
        # landing folds); closed_nodes = the live dense state space (one
        # entry per (flank, gap, cell)).  These are dense-DP counters, not
        # A* node expansions — comparable as work, not one-to-one
        # (documented in README/PARITY; reference fills node counts at
        # alignment_result.rs:50-82).
        F = self.costs.left_flank_length + self.costs.right_flank_length + 1
        cells = (len(ref_arr) + 1) * (len(qry_arr) + 1)
        opened = self._last_cells or cells
        if duration > 0:
            logger.debug(
                "DP work: %d cells, %.3g cells/sec", opened, opened / duration
            )
        res = AlignmentResult.new(
            alignment=alignment,
            reference=reference.upper(),
            query=query.upper(),
            reference_rc=al.reverse_complement_str(reference.upper()),
            query_rc=al.reverse_complement_str(query.upper()),
            reference_name=reference_name,
            query_name=query_name,
            reference_offset=rng.reference_offset,
            query_offset=rng.query_offset,
            result=result,
            duration_seconds=duration,
            opened_nodes=opened,
            closed_nodes=F * 3 * cells,
            suboptimal_opened_nodes=0,
        )
        return TSPairwiseAlignment(res)


@dataclass
class TSPairwiseAlignment:
    """Mirror of the pyo3 TSPairwiseAlignment (python_bindings/src/lib.rs:17-51)."""

    result: AlignmentResult

    def cigar(self) -> str:
        return self.result.cigar()

    def stats(self) -> dict:
        r = self.result
        return {
            "cost": r.cost,
            "cost_per_base": r.cost_per_base,
            "duration_seconds": r.duration_seconds,
            "opened_nodes": r.opened_nodes,
            "closed_nodes": r.closed_nodes,
            "suboptimal_opened_nodes": r.suboptimal_opened_nodes,
            "suboptimal_opened_nodes_ratio": r.suboptimal_opened_nodes_ratio,
            "template_switch_amount": r.template_switch_amount,
            "runtime": r.runtime,
            "memory": r.memory,
        }

    def alignments(self) -> List[Tuple[int, object]]:
        return list(self.result.alignment.entries) if self.result.alignment else []

    def has_target(self) -> bool:
        return self.result.has_target

    def to_toml(self) -> str:
        return self.result.to_toml()

    def viz_template_switches(self) -> None:
        """Print the per-TSM plain-text view to stdout
        (python_bindings/src/lib.rs:45-50 parity)."""
        import sys

        from .show.plain_text import show_template_switches

        show_template_switches(sys.stdout, self.result)


def align(
    reference: str,
    query: str,
    costs: Optional[str] = None,
    alphabet: str = "dna-n",
    *,
    device: str,
    **kwargs,
) -> TSPairwiseAlignment:
    """Module-level convenience (python/tsalign/__init__.py parity).

    Keyword arguments matching Aligner settings (engine, no_ts, strategy
    selectors, chunk, ...) configure the aligner, mirroring the reference
    binding's depythonized settings struct (python_bindings/src/lib.rs:66-91);
    the rest (range_, cost_limit, ...) go to the per-call align()."""
    import dataclasses

    setting_names = {f.name for f in dataclasses.fields(Aligner)}
    settings = {k: v for k, v in kwargs.items() if k in setting_names}
    call_kwargs = {k: v for k, v in kwargs.items() if k not in setting_names}
    a = Aligner(alphabet=alphabet, device=device, **settings)
    if costs is not None:
        a.set_costs_parse(costs)
    return a.align(reference, query, **call_kwargs)
