"""Chained long-sequence alignment driver.

Counterpart of lib_ts_chainalign/src/lib.rs align() + chain_align.rs: anchor
the pair, chain, cut the pair at midpoints of confident exact-match runs,
run the dense TS engine per segment (with window-radius context so template
switches near segment borders can read their secondary stretches, mirroring
the reference's range semantics where TS inners may align outside the focus
range — README.md:239-284), and concatenate the per-segment alignments.

Segment locality is sound because every cost function window is finite: a
TSM entered inside a segment reads secondary characters at most
(offset window + max length + drift) characters away.

This is the port's copy of ``tsalign_tpu/chain/driver.py``, with these
differences:

  * `chain_align` takes a required `device` ("cuda" or "cpu") and
    ``engine="device"`` (the default) or ``"numpy"``; there is no "auto"
    that drops to numpy when the device engine cannot be imported;
  * the per-segment path runs ``engine.TorchAligner`` and the batched path
    ``parallel/batch_ts.py::BatchedTSAligner``, both on `device`;
  * a sub-batch carries only its real windows: the all-poison dummy pairs
    that padded it to a fixed size for the TPU's compiled batch sizes are
    gone (a launch takes any pair count);
  * the result counts the windows that overflowed the device int32 domain
    and went to the numpy engine (`numpy_fallbacks`), and says whether the
    anchors came from the native kernel (`anchors_native`);
  * `progress=True` prints the probe's cost on a rejoin (the source prints
    an undefined name there), and `_align_segments_batched` says what it
    returns: None for each window of an overflowing group.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..alignment import PRIMARY_MATCH, Alignment
from ..config import TemplateSwitchConfig
from ..costs import INF
from ..geometry import AlignmentRange
from .anchors import Anchors, choose_k
from .chain import compute_chain, exact_match_runs
from .plan import infer_max_n, load_or_create_plan


@dataclass
class ChainAlignResult:
    cost: int
    alignment: Alignment
    segments: int
    anchors: int
    duration_seconds: float
    ts_total_length: int = 0
    cuts_rejoined: int = 0  # cuts removed by the verification pass
    # windows the device engine could not take (int32 overflow), aligned by
    # the numpy engine instead
    numpy_fallbacks: int = 0
    anchors_native: bool = False  # anchors from csrc/anchors.cpp


def _window_radius(config: TemplateSwitchConfig) -> int:
    """Max distance a TSM secondary/reentry can reach from its entry cell."""
    r = 0
    for fn in (config.rq_qr_offset_costs, config.rr_qq_offset_costs):
        w = fn.finite_window()
        if w is not None:
            r = max(r, abs(int(w[0])), abs(min(int(w[1]), 2**32)))
    dmax = 0
    dw = config.length_difference_costs.finite_window()
    if dw is not None:
        dmax = max(abs(int(dw[0])), abs(min(int(dw[1]), 2**32)))
    lw = config.length_costs.maximum_finite_input()
    if lw is not None:
        lmax = int(lw)
    else:
        # Length unbounded by its own cost function, but still bounded by
        # the anti-gap window: the exit walk requires p2 + ldiff in
        # [Al, Ah] (engine semantics; context.rs:636-707), so the secondary
        # length p2 <= max Ah - min ldiff <= max |A window| + max |ldiff|.
        amax = 0
        for d in ("Forward", "Reverse"):
            aw = config.anti_primary_gap_costs(d).finite_window()
            if aw is not None:
                amax = max(amax, abs(int(aw[0])), abs(min(int(aw[1]), 2**32)))
        lmax = amax + dmax
    r += lmax + dmax
    return r + 16


def _segment_cuts(
    runs: List[Tuple[int, int, int]],
    n_r: int,
    n_q: int,
    min_run: int,
    target_segment: int,
    start: Tuple[int, int] = (0, 0),
) -> List[Tuple[int, int]]:
    """Cut points (ref, qry) inside long exact runs, from `start` to
    (n_r, n_q).

    A qualifying run gets cuts near BOTH ends (and every `target_segment`
    within), so the run interior becomes fully-exact segments (free via the
    driver's exact-match short-circuit) and each divergent island between
    runs gets a tight segment — the engine then only pays for islands,
    which is what makes long near-identical pairs cheap (the role the
    anchor-gap decomposition plays in the reference's chain_align.rs)."""
    cuts = [start]

    def try_add(cr: int, cq: int) -> None:
        if cr >= n_r or cq >= n_q:
            return
        if cr - cuts[-1][0] >= 16 and cq - cuts[-1][1] >= 16:
            cuts.append((cr, cq))

    pad = max(16, min_run)
    for r0, q0, length in runs:
        if length < min_run:
            continue
        edge = min_run // 2 + 4
        if length >= 2 * edge + 16:
            # Candidate cuts: both run ends, plus a pad cut just inside each
            # end so the island-adjacent exact segments stay narrow (the
            # verification merge window spans cut-adjacent segments, so
            # narrow neighbours keep re-verification cheap), plus interior
            # cuts every `target_segment` (interior exact segments merge via
            # the exact-match short-circuit for free).
            pos_list = [edge, edge + pad]
            pos = edge + pad + target_segment
            while pos < length - edge - pad:
                pos_list.append(pos)
                pos += target_segment
            pos_list += [length - edge - pad, length - edge]
            for pos in pos_list:
                if edge <= pos <= length - edge:
                    try_add(r0 + pos, q0 + pos)
        else:
            try_add(r0 + length // 2, q0 + length // 2)
    if cuts[-1] != (n_r, n_q):
        cuts.append((n_r, n_q))
    return cuts


def _bucket(n: int) -> int:
    b = 64
    while b < n:
        b *= 2
    return b


@dataclass
class _SegmentOutcome:
    cost: int  # true (unscaled) optimal cost of the segment
    ts_length: int  # total TS length of the co-optimal maximum-length path
    alignment: Alignment
    numpy_fallback: bool = False  # the device engine overflowed


def _exact_shortcut(
    config: TemplateSwitchConfig,
    ref: np.ndarray,
    qry: np.ndarray,
    cut0: Tuple[int, int],
    cut1: Tuple[int, int],
) -> Optional[_SegmentOutcome]:
    """Exact-match short-circuit: when the focus pair is identical and every
    TSM has positive true cost, the all-match alignment (cost 0, zero TS
    length) is the unique lexicographic optimum — most segments of
    near-identical long pairs take this path and skip the engine."""
    (r0, q0), (r1, q1) = cut0, cut1
    if (
        r1 - r0 == q1 - q0
        and config.left_flank_length == 0
        and config.right_flank_length == 0
        and np.array_equal(ref[r0:r1], qry[q0:q1])
        and (
            config.primary_edit_costs.substitution[
                ref[r0:r1], ref[r0:r1]
            ]
            == 0
        ).all()
    ):
        from ..numpy_engine import min_tsm_cost_bound

        if min_tsm_cost_bound(config) > 0:
            aln = Alignment([])
            if r1 > r0:
                aln.push(PRIMARY_MATCH, r1 - r0)
            return _SegmentOutcome(cost=0, ts_length=0, alignment=aln)
    return None


def _align_segment(
    config: TemplateSwitchConfig,
    ref: np.ndarray,
    qry: np.ndarray,
    cut0: Tuple[int, int],
    cut1: Tuple[int, int],
    radius: int,
    device,
    max_template_switches: Optional[int],
    with_traceback: bool = True,
) -> _SegmentOutcome:
    """Align one segment [cut0, cut1] with window-radius context, under the
    K-scaled total-length tie-break algebra (the reference CLI default,
    align.rs:115-117).  Per-segment scaling composes lexicographically:
    cuts make segments independent, so the global (cost, -ts_length)
    optimum is the segment-wise one.  `device`: where the device engine
    runs; None runs the numpy engine."""
    n_r, n_q = len(ref), len(qry)
    (r0, q0), (r1, q1) = cut0, cut1
    sc = _exact_shortcut(config, ref, qry, cut0, cut1)
    if sc is not None:
        return sc
    cr0, cq0 = max(0, r0 - radius), max(0, q0 - radius)
    cr1, cq1 = min(n_r, r1 + radius), min(n_q, q1 + radius)
    sub_r = ref[cr0:cr1]
    sub_q = qry[cq0:cq1]
    if device is not None:
        P = config.alphabet.size
        br, bq = _bucket(len(sub_r)), _bucket(len(sub_q))
        sub_r = np.concatenate([sub_r, np.full(br - len(sub_r), P, sub_r.dtype)])
        sub_q = np.concatenate([sub_q, np.full(bq - len(sub_q), P, sub_q.dtype)])
    rng = AlignmentRange(r0 - cr0, q0 - cq0, r1 - cr0, q1 - cq0)
    # Verification probes compare COSTS only (see try_window), so they run
    # the UNSCALED algebra: the K-scaled magnitudes of large merged windows
    # overflow the device int32 domain, and round 5's chain100k device run
    # burned its whole budget in the resulting per-window numpy fallbacks.
    K = 1
    if with_traceback:
        while K < len(sub_r) + len(sub_q) + 2:
            K *= 2
    cfg_scaled = config.scaled_for_length_tiebreak(K) if K > 1 else config
    kw = dict(
        range_=rng,
        # TSLB bounds are a speed trade on segments (exact either way):
        # narrow-window configs converge in 2-3 cheap rounds and the value
        # iteration dominates (91% of a profiled multi-kb chain wall);
        # wide-window configs have expensive module sweeps where the
        # bound's early stops pay for themselves (measured 33 s vs 73 s on
        # the wide-window adversarial test).
        use_lower_bounds=radius > 64,
        # The numpy engine prunes to the focus range (exact context
        # bounding); the device engine runs NoPrune over the poisoned
        # bucket so segment shapes share compilations — primary roaming
        # within the context matches the full-pair NoPrune semantics.
        max_template_switches=max_template_switches,
    )
    comp, aln = None, None
    if device is not None:
        try:
            from ..engine import TorchAligner

            # Cost-only probes skip field retention entirely (keep_fields
            # would pin per-round fields the probe never reads); traceback
            # segments keep fields device-resident and fetch row blocks on
            # demand (fields.py) instead of a full (F, 3, n, n) copy to
            # the host per round.
            eng = TorchAligner(
                cfg_scaled, sub_r, sub_q, prune_range=False,
                keep_fields="device" if with_traceback else False,
                device=device, **kw
            )
            if with_traceback:
                comp, aln = eng.align_with_traceback()
            else:
                comp = eng.align().cost
        except OverflowError:
            comp = None  # scaled magnitudes exceed int32: numpy fallback
    fallback = comp is None and device is not None
    if comp is None:
        from ..numpy_engine import DenseAligner

        eng = DenseAligner(cfg_scaled, sub_r, sub_q, prune_range=True, **kw)
        if with_traceback:
            comp, aln = eng.align_with_traceback()
        else:
            comp = eng.align().cost
    if comp >= INF:
        raise RuntimeError(
            f"chain_align: segment R[{r0}..{r1}] Q[{q0}..{q1}] has no alignment"
        )
    cost = -(-comp // K)
    return _SegmentOutcome(cost=cost, ts_length=K * cost - comp, alignment=aln,
                           numpy_fallback=fallback)


def _align_segments_batched(
    config: TemplateSwitchConfig,
    ref: np.ndarray,
    qry: np.ndarray,
    windows: List[Tuple[Tuple[int, int], Tuple[int, int]]],
    radius: int,
    with_traceback: bool,
    progress: bool = False,
    *,
    device,
) -> List[Optional[_SegmentOutcome]]:
    """Batched device execution of engine-needing windows: segments are
    bucketed by their padded context shape and each bucket runs ONE
    lockstep batched engine (BatchedTSAligner with per-segment focus
    ranges, on `device`).  The per-segment path pays per-segment host
    builds and per-round launches for every island.  Returns one outcome
    per window, None for each window of a group whose K-scaled magnitudes
    overflow the device int32 domain (the caller aligns those per
    segment)."""
    from ..parallel.batch_ts import BatchedTSAligner

    n_r, n_q = len(ref), len(qry)
    prepped = []  # (bucket_key, index, sub_r, sub_q, rng)
    for idx, (cut0, cut1) in enumerate(windows):
        (r0, q0), (r1, q1) = cut0, cut1
        cr0, cq0 = max(0, r0 - radius), max(0, q0 - radius)
        cr1, cq1 = min(n_r, r1 + radius), min(n_q, q1 + radius)
        # Raw (unpadded) subsequences: BatchedTSAligner poison-pads to the
        # group bucket itself and derives the REAL structural bounds from
        # the content (padded-soundness).
        sub_r, sub_q = ref[cr0:cr1], qry[cq0:cq1]
        br, bq = _bucket(len(sub_r)), _bucket(len(sub_q))
        rng = AlignmentRange(r0 - cr0, q0 - cq0, r1 - cr0, q1 - cq0)
        prepped.append(((br, bq), idx, sub_r, sub_q, rng))

    out: List[Optional[_SegmentOutcome]] = [None] * len(windows)
    groups: dict = {}
    for key, idx, sub_r, sub_q, rng in prepped:
        groups.setdefault(key, []).append((idx, sub_r, sub_q, rng))
    for (br, bq), items in sorted(groups.items()):
        # Sub-batch cap scaled by bucket AREA: HBM holds B fields of
        # br*bq cells (plus max_rounds+1 stacked round slots in traceback
        # mode) — a flat cap of 32 at the 2048 bucket RESOURCE_EXHAUSTED
        # the TPU (round-5 chain100k).  The caps are powers of two.
        area = br * bq
        budget = (8 if with_traceback else 32) * 256 * 256
        cap = 1
        while cap * 2 * area <= budget and cap < (8 if with_traceback else 32):
            cap *= 2
        K = 1
        if with_traceback:
            while K < br + bq + 2:
                K *= 2
        cfg_scaled = (
            config.scaled_for_length_tiebreak(K) if K > 1 else config
        )
        for c0 in range(0, len(items), cap):
            if progress:
                print(
                    f"batched {'traceback' if with_traceback else 'probe'} "
                    f"bucket {br}x{bq}: items {c0}..{min(c0 + cap, len(items))}"
                    f"/{len(items)}",
                    flush=True,
                )
            chunk_items = items[c0 : c0 + cap]
            pairs = [(sr, sq) for _, sr, sq, _ in chunk_items]
            ranges = [rng for *_, rng in chunk_items]
            try:
                bt = BatchedTSAligner(
                    cfg_scaled, pairs, ranges=ranges,
                    keep_fields="device" if with_traceback else False,
                    use_lower_bounds=radius > 64, device=device,
                )
                if with_traceback:
                    traced = bt.align_with_traceback()
                else:
                    traced = [(r.cost, None) for r in bt.align()]
            except OverflowError:
                # This GROUP's scaled magnitudes exceed the device int32
                # domain: leave its outcomes None (per-segment fallback)
                # without abandoning the other groups' batches.
                continue
            for (idx, *_), (comp, aln) in zip(chunk_items, traced):
                if comp >= INF:
                    (r0, q0), (r1, q1) = windows[idx]
                    raise RuntimeError(
                        f"chain_align: segment R[{r0}..{r1}] Q[{q0}..{q1}] "
                        f"has no alignment"
                    )
                cost = -(-comp // K)
                out[idx] = _SegmentOutcome(
                    cost=cost, ts_length=K * cost - comp, alignment=aln
                )
    return out


def chain_align(
    config: TemplateSwitchConfig,
    reference: np.ndarray,
    query: np.ndarray,
    k: Optional[int] = None,
    target_segment: int = 512,
    max_template_switches: Optional[int] = None,
    engine: str = "device",
    progress: bool = False,
    range_: Optional[AlignmentRange] = None,
    cache_directory: Optional[str] = None,
    force_no_preprocessing: bool = False,
    verify: bool = True,
    verify_spans: Tuple[int, ...] = (2, 3),
    certify_footprint: bool = True,
    *,
    device,
) -> ChainAlignResult:
    t_start = time.monotonic()
    ref = np.asarray(reference)
    qry = np.asarray(query)
    n_r, n_q = len(ref), len(qry)
    if range_ is None:
        range_ = AlignmentRange.complete(n_r, n_q)
    ro, qo = range_.reference_offset, range_.query_offset
    rl, ql = range_.reference_limit, range_.query_limit
    if k is None:
        k = choose_k((rl - ro) + (ql - qo))

    # Planning data: loaded from the preprocessing cache when present, else
    # derived from the config and stored (a_star_chain_ts.rs:49-70).
    plan = load_or_create_plan(
        config,
        cache_directory,
        k,
        infer_max_n(rl - ro, ql - qo),
        force_no_preprocessing=force_no_preprocessing,
    )

    # Anchor/chain over the focus range only (the primary alignment is
    # restricted to it, lib_ts_chainalign sequences.rs primary start/end);
    # segment context below may still read secondary characters outside it.
    anchors = Anchors.build(ref[ro:rl], qry[qo:ql], k)
    chain = compute_chain(
        anchors, match_score=plan.match_score, drift_unit=plan.drift_unit
    )
    runs = [(r0 + ro, q0 + qo, ln) for r0, q0, ln in exact_match_runs(chain)]
    radius = plan.window_radius
    cuts = _segment_cuts(runs, rl, ql, plan.min_run, target_segment, start=(ro, qo))

    if engine not in ("device", "numpy"):
        raise ValueError(f"chain_align: engine must be 'device' or 'numpy', not {engine!r}")
    # where the engine runs; None runs the numpy engine
    seg_device = device if engine == "device" else None
    fallbacks_box = [0]

    # Segment execution: exact-match short-circuits first (host, free),
    # then — on the device engine — ALL remaining segments batched per
    # bucket shape (each bucket one lockstep batch,
    # _align_segments_batched); the per-segment loop is the numpy path and
    # the fallback.
    outcomes: List[Optional[_SegmentOutcome]] = [None] * (len(cuts) - 1)
    engine_windows: List[Tuple[int, Tuple, Tuple]] = []
    for s, (cut0, cut1) in enumerate(zip(cuts, cuts[1:])):
        sc = _exact_shortcut(config, ref, qry, cut0, cut1)
        if sc is not None:
            outcomes[s] = sc
        else:
            engine_windows.append((s, cut0, cut1))
    if progress:
        print(
            f"segments: {len(outcomes)} total, {len(engine_windows)} need "
            f"the engine", flush=True,
        )
    batched = None
    if seg_device is not None and engine_windows and max_template_switches is None:
        batched = _align_segments_batched(
            config, ref, qry, [(c0, c1) for _, c0, c1 in engine_windows],
            radius, with_traceback=True, progress=progress, device=seg_device,
        )
    if batched is not None:
        for (s, _c0, _c1), out in zip(engine_windows, batched):
            outcomes[s] = out
    # Per-segment path for whatever remains: the numpy engine mode, the
    # max_template_switches mode, or individual groups whose scaled
    # magnitudes overflowed the device domain (their outcomes stay None
    # above).
    remaining = [w for w in engine_windows if outcomes[w[0]] is None]
    for n_done, (s, cut0, cut1) in enumerate(remaining):
        if progress:
            print(
                f"segment {n_done + 1}/{len(remaining)}: "
                f"R[{cut0[0]}..{cut1[0]}] Q[{cut0[1]}..{cut1[1]}]",
                flush=True,
            )
        outcomes[s] = _align_segment(
            config, ref, qry, cut0, cut1, radius, seg_device,
            max_template_switches,
        )
        fallbacks_box[0] += outcomes[s].numpy_fallback
    segments = len(outcomes)

    # Verification pass: convergence analog of the reference's
    # iterate-chain / evaluate-exactly loop (chain_align.rs:157-282).
    # Re-align merged windows across consecutive segment groups and require
    # that the interior cuts did not lose (cost, -ts_length) optimality;
    # losing cuts are removed and the merged alignment adopted.  Two window
    # families: a cheap fixed ladder (verify_spans) that catches single- and
    # double-cut structures, and per-cut FOOTPRINT CERTIFICATES that cover a
    # full TSM-footprint radius on both sides of every surviving cut (see
    # the in-loop comment; tests/test_chain.py::test_verification_catches_
    # three_segment_structures and ::test_footprint_certificate_catches_
    # wide_structures).  The sweep repeats until a full pass finds no
    # improvement — the same stop condition as the reference's loop
    # (evaluated cost stopped improving).
    cuts_rejoined_box = [0]
    if verify:
        from ..numpy_engine import min_tsm_cost_bound

        # Provable-skip certificate: when every part of a window aligned
        # all-match (cost 0, ts_length 0) and every TSM has positive true
        # cost, the merged optimum is the same all-match alignment — cost
        # cannot go below 0, a cost-0 tie-break improvement would need a
        # zero-cost TSM, and equal (cost, -ts_length) means no rejoin.
        # Skipping these windows is exact and removes the bulk of the
        # verification work on near-identical long pairs.
        all_match_safe = min_tsm_cost_bound(config) > 0

        merged_memo: dict = {}  # (cut0, cut1) -> cost-only probe outcome
        traced_memo: dict = {}  # (cut0, cut1) -> full outcome (adoption)

        def merged_window(cut0, cut1, with_traceback):
            # Verification only needs (cost, ts_length) to certify a cut;
            # the merged ALIGNMENT is computed only for adopted windows.
            memo = traced_memo if with_traceback else merged_memo
            if (cut0, cut1) not in memo:
                memo[(cut0, cut1)] = _align_segment(
                    config, ref, qry, cut0, cut1, radius, seg_device,
                    max_template_switches, with_traceback=with_traceback,
                )
                fallbacks_box[0] += memo[(cut0, cut1)].numpy_fallback
            return memo[(cut0, cut1)]

        fp = radius

        def cert_window(i):
            """Minimal cut-index window covering [cuts[i] - fp, cuts[i] + fp]
            on both axes (the footprint certificate's probe window)."""
            cr, cq = cuts[i]
            ja = 0
            for j in range(i - 1, -1, -1):
                if cuts[j][0] <= cr - fp and cuts[j][1] <= cq - fp:
                    ja = j
                    break
            jb = len(cuts) - 1
            for j in range(i + 1, len(cuts)):
                if cuts[j][0] >= cr + fp and cuts[j][1] >= cq + fp:
                    jb = j
                    break
            return ja, jb

        def cert_window_if_needed(i):
            """The certificate window for cut i, or None when the ladder
            already covers it or the CLEAN-CORE skip applies: when every
            segment overlapping the fp-core [c - fp, c + fp] is all-match
            (cost 0, ts 0) and TSMs have positive cost, any single TSM
            crossing cut i lies inside that clean core (footprint bound)
            and would have to beat an all-match stretch with a
            positive-cost TSM — impossible; improving structures living
            elsewhere in the window cross OTHER cuts and are certified by
            those cuts' own windows.  Without this skip, every interior
            cut of a long exact run spawned a multi-kb probe (174 windows
            at the 2048 bucket in the round-5 chain100k run)."""
            ja, jb = cert_window(i)
            if jb - ja <= max(verify_spans):
                return None
            if all_match_safe:
                cr, cq = cuts[i]
                core_clean = True
                for s2 in range(ja, jb):
                    if (
                        cuts[s2 + 1][0] <= cr - fp
                        or cuts[s2][0] >= cr + fp
                    ) and (
                        cuts[s2 + 1][1] <= cq - fp
                        or cuts[s2][1] >= cq + fp
                    ):
                        continue  # outside the core on both axes
                    o = outcomes[s2]
                    if o.cost != 0 or o.ts_length != 0:
                        core_clean = False
                        break
                if core_clean:
                    return None
            return ja, jb

        def window_split(s, span):
            parts = outcomes[s : s + span]
            return (
                sum(o.cost for o in parts),
                -sum(o.ts_length for o in parts),
            )

        def ladder_oversized(s, span):
            """A ladder window spanning a multi-kb exact stretch is
            redundant: any single-TSM structure crossing its cuts fits in
            the (bounded) footprint-certificate windows of those cuts, so
            probing the huge merged window buys nothing the certificates
            don't — and each oversized probe is a full engine run at the
            2048+ bucket (174 of them burned the round-5 chain100k
            budget)."""
            if not certify_footprint:
                return False  # no certificates to fall back on
            cap_bp = max(6 * fp, 768)
            (r0, q0), (r1, q1) = cuts[s], cuts[s + span]
            return (r1 - r0) > cap_bp or (q1 - q0) > cap_bp

        def prefetch_pass():
            """Batch this pass's candidate probe windows through the device
            engine (one lockstep batch per bucket shape) so the sequential
            rejoin logic below hits the memo — the per-window probe path
            pays a full engine run per window."""
            wanted, seen = [], set()

            def want(s, span):
                if s < 0 or s + span > len(outcomes):
                    return
                if all_match_safe and window_split(s, span) == (0, 0):
                    return
                if span <= max(verify_spans) and ladder_oversized(s, span):
                    return
                w = (cuts[s], cuts[s + span])
                if w not in merged_memo and w not in seen:
                    seen.add(w)
                    wanted.append(w)

            for span in verify_spans:
                for s in range(0, len(outcomes) - span + 1):
                    want(s, span)
            if certify_footprint:
                for i in range(1, len(cuts) - 1):
                    w = cert_window_if_needed(i)
                    if w is not None:
                        want(w[0], w[1] - w[0])
            if not wanted:
                return
            probed = _align_segments_batched(
                config, ref, qry, wanted, radius, with_traceback=False,
                progress=progress, device=seg_device,
            )
            for w, o in zip(wanted, probed):
                if o is not None:  # overflow groups fall to per-window
                    merged_memo[w] = o

        def try_window(s, span):
            """Probe the merged window over outcomes[s:s+span]; rejoin its
            interior cuts when the merge wins on COST.  Returns True on
            rejoin.  Probes compare costs only: the split alignment is
            itself achievable in the merged window, so equal cost means no
            cost defect; a strictly-longer-TS co-optimal refinement across
            a cut is not chased (the reference's chain iterate/evaluate
            loop is likewise cost-driven, chain_align.rs:157-282 — and the
            K-scaled probe algebra overflows int32 on large windows)."""
            split = window_split(s, span)
            if all_match_safe and split == (0, 0):
                return False
            probe = merged_window(cuts[s], cuts[s + span], False)
            if probe.cost >= split[0]:
                return False
            if progress:
                print(
                    f"verification: cuts {cuts[s + 1:s + span]} "
                    f"suboptimal (cost {split[0]} -> {probe.cost}), rejoining",
                    flush=True,
                )
            merged_out = merged_window(cuts[s], cuts[s + span], True)
            cuts_rejoined_box[0] += span - 1
            del cuts[s + 1 : s + span]
            outcomes[s : s + span] = [merged_out]
            return True

        while True:
            changed = False
            if seg_device is not None and max_template_switches is None:
                prefetch_pass()
            # Base ladder: cheap fixed spans first (they catch the common
            # single- and double-cut structures with small windows);
            # oversized windows defer to the footprint certificates.
            for span in verify_spans:
                s = 0
                while s + span <= len(outcomes):
                    if not ladder_oversized(s, span) and try_window(s, span):
                        changed = True
                        s = max(0, s - 1)
                    else:
                        s += 1
            # Footprint certificates (VERDICT r4 weak #5: the fixed ladder
            # is blind to structures wider than its widest span, and no
            # partial improvement need exist below the full span — a TSM
            # whose base cost exceeds one stripe's savings improves NOTHING
            # until the whole footprint is visible).  A template switch
            # crossing cut c has its primary footprint inside
            # [c - fp, c + fp] (fp = the config's window radius, which
            # bounds offset + inner length + drift — _window_radius), so
            # probing, per interior cut, ONE window that covers that range
            # certifies the cut against ANY single-TSM-crossing structure;
            # the outer convergence loop (same stop as the reference's
            # iterate/evaluate loop, chain_align.rs:157-282) composes the
            # certificates across interacting TSMs.
            if certify_footprint:
                i = 1
                while i < len(cuts) - 1:
                    w = cert_window_if_needed(i)
                    if w is not None and try_window(w[0], w[1] - w[0]):
                        changed = True
                        i = max(1, w[0])
                    else:
                        i += 1
            if not changed:
                break
        segments = len(outcomes)

    total_cost = sum(o.cost for o in outcomes)
    ts_total_length = sum(o.ts_length for o in outcomes)
    merged = Alignment([])
    for o in outcomes:
        for nmul, t in o.alignment.entries:
            merged.push(t, nmul)

    return ChainAlignResult(
        cost=total_cost,
        alignment=merged,
        segments=segments,
        anchors=len(anchors),
        duration_seconds=time.monotonic() - t_start,
        ts_total_length=ts_total_length,
        cuts_rejoined=cuts_rejoined_box[0],
        numpy_fallbacks=fallbacks_box[0],
        anchors_native=anchors.native,
    )
