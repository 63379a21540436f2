"""Admissible remaining-cost lower bounds (TSLB counterpart).

The reference precomputes a whole-TSM lower-bound matrix indexed by reentry
displacement by running its aligner on a synthetic genome with secondary
costs collapsed to match-agnostic minima
(lib_tsalign/src/a_star_aligner/lower_bounds/template_switch.rs:75-284) and
uses it to raise A* node bounds (strategies/chaining.rs:157-211).  The dense
engine's counterpart is closed-form: a TSM of kind (pk, sk, dk) maps an entry
cell (p1, e) to a reentry cell (p1 + l, e + ag) at real cost

    entrance(fo) + secondary(l) + length(l) + ldiff(ag - l) + anti(ag)

(ops/tsm_modules.py module decomposition), which is bounded below by the
displacement-separable kernel

    K(l, ag) = seed_min + ldiff_min + sec_step * l + length(l) + anti(ag)

where seed_min = min finite entrance cost (base + offset walk), sec_step =
the cheapest per-level secondary transition (match-agnostic, including the
total-length tie-break bonus), and ldiff_min the cheapest finite
length-difference cost.  Every feasibility constraint the real TSM must obey
(offset walk bounds, anti-gap walk bounds, strict reentry) only restricts the
real move set, so dropping them keeps the bound admissible.

From these kernels we compute

    B[i, j] = lower bound on the cost of completing an alignment from any
              Primary state at cell (i, j) to the target corner,

as the exact optimum of the *relaxed* cell graph: primary moves priced by the
elementwise minimum of the primary and flank tables (left-flank ops are
usable as primary ops, the climb quirk), gap steps priced min(open, extend),
plus the TSM displacement kernels as shortcut edges.  B is consistent
(a true shortest-path field of the relaxed graph), so pruning forward values
v with v + B > best and stopping the engine's round loop when the pruned
entry field is stable is exact (any path through a pruned cell costs more
than the incumbent).

The one-TSM entry bound

    S[i, j] = min over kinds of min_{l, ag} K(l, ag) + B(reentry cell)

prices "start a TSM here and finish": entry cells with A + S > best cannot
lie on an optimal (or co-optimal under the scaled tie-break algebra) path.

All fields are host numpy int64 in the engine's exact algebra; the kernels'
separability turns each shortcut application into a handful of O(cells)
sliding-window minima (piecewise-constant cost functions decompose into a few
constant segments; the sec_step * l slope is handled with the affine
transform trick).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .config import TemplateSwitchConfig
from .costs import INF, CostFunction
from .ops.primary_sweep import CLAMP
from .ops.tsm_modules import make_kind_spec

_PK = ("Reference", "Query")
_DK = ("Forward", "Reverse")
_BIG = INF // 2  # values >= _BIG are treated as infinite


def _capmin(a: np.ndarray) -> np.ndarray:
    return np.minimum(a, INF)


def windowed_min(arr: np.ndarray, a: int, b: int, axis: int = -1) -> np.ndarray:
    """out[t] = min(arr[t + a .. t + b]) along `axis`, INF outside the array.

    Classic two-scan block decomposition: O(elements), no Python loop over
    the window.
    """
    if a > b:
        return np.full_like(arr, INF)
    x = np.moveaxis(arr, axis, -1)
    n = x.shape[-1]
    w = b - a + 1
    # y[u] = x[u + a] for u in [0, n + w - 1), INF out of range.
    ylen = n + w - 1
    y = np.full(x.shape[:-1] + (ylen,), INF, dtype=np.int64)
    src_lo = max(0, a)
    src_hi = min(n, ylen + a)
    if src_lo < src_hi:
        y[..., src_lo - a : src_hi - a] = x[..., src_lo:src_hi]
    m = -(-ylen // w) * w
    if m > ylen:
        y = np.concatenate(
            [y, np.full(x.shape[:-1] + (m - ylen,), INF, dtype=np.int64)], axis=-1
        )
    blocks = y.reshape(x.shape[:-1] + (m // w, w))
    pre = np.minimum.accumulate(blocks, axis=-1).reshape(x.shape[:-1] + (m,))
    suf = np.minimum.accumulate(blocks[..., ::-1], axis=-1)[..., ::-1].reshape(
        x.shape[:-1] + (m,)
    )
    t = np.arange(n)
    out = np.minimum(suf[..., t], pre[..., t + w - 1])
    return np.moveaxis(out, -1, axis)


def _finite_const_segments(fn: CostFunction, lo: int, hi: int) -> List[Tuple[int, int, int]]:
    """Maximal constant finite segments [(a, b, cost)] of fn over [lo, hi]."""
    segs: List[Tuple[int, int, int]] = []
    cur = None
    for x in range(lo, hi + 1):
        c = fn.evaluate(x) if x >= fn.points[0][0] else INF
        if c >= INF:
            if cur:
                segs.append(tuple(cur))
                cur = None
            continue
        if cur and cur[2] == c:
            cur[1] = x
        else:
            if cur:
                segs.append(tuple(cur))
            cur = [x, x, c]
    if cur:
        segs.append(tuple(cur))
    return segs


@dataclass(frozen=True)
class KindKernel:
    """Displacement-separable lower-bound kernel of one TSM kind."""

    pk: int
    const: int  # seed_min + ldiff_min
    sec_step: int  # per-level secondary transition lower bound (may be < 0)
    l_segments: Tuple[Tuple[int, int, int], ...]  # (a, b, length_cost)
    ag_segments: Tuple[Tuple[int, int, int], ...]  # (a, b, anti_cost)


def kind_kernels(
    config: TemplateSwitchConfig, n_r: int, n_q: int
) -> List[KindKernel]:
    """Admissible displacement kernels for all active kinds.

    Secondary-deletion drift is unbudgeted here (deletions only add cost,
    so they never lower the bound); the kernels are therefore valid for any
    sdel budget the engine later uses.
    """
    kernels: List[KindKernel] = []
    ldiff_fn = config.length_difference_costs
    dw = ldiff_fn.finite_window()
    if dw is None:
        return kernels
    for pk in (0, 1):
        for sk in (0, 1):
            for dk in (0, 1):
                spec = make_kind_spec(config, n_r, n_q, pk, sk, dk, sdel_budget=0)
                if spec is None:
                    continue
                seed_fin = spec.seed[spec.seed < INF]
                if seed_fin.size == 0:
                    continue
                seed_min = int(seed_fin.min())
                d_lo = max(int(dw[0]), -(spec.n_anti + spec.l_max + 1))
                d_hi = min(int(dw[1]), spec.n_anti + spec.l_max + 1)
                dmin = ldiff_fn.min_in(d_lo, d_hi + 1)
                if dmin is None or dmin >= INF:
                    continue
                table = config.secondary_edit_costs(_DK[dk])
                fins = [
                    arr[arr < INF]
                    for arr in (table.substitution, table.gap_open, table.gap_extend)
                ]
                steps = [int(f.min()) for f in fins if f.size]
                if not steps:
                    continue
                sec_step = min(steps) - config.secondary_length_bonus
                l_segs = _finite_const_segments(
                    config.length_costs, spec.min_len, spec.l_max
                )
                if not l_segs:
                    continue
                anti_fn = config.anti_primary_gap_costs(_DK[dk])
                aw = anti_fn.finite_window()
                if aw is None:
                    continue
                s_lo = max(int(aw[0]), spec.min_len + d_lo, -spec.n_anti)
                s_hi = min(int(aw[1]), spec.l_max + d_hi, spec.n_anti)
                if s_lo > s_hi:
                    continue
                ag_segs = _finite_const_segments(anti_fn, s_lo, s_hi)
                if not ag_segs:
                    continue
                kernels.append(
                    KindKernel(
                        pk=pk,
                        const=seed_min + int(dmin),
                        sec_step=sec_step,
                        l_segments=tuple(l_segs),
                        ag_segments=tuple(ag_segs),
                    )
                )
    return kernels


def relaxed_move_costs(config: TemplateSwitchConfig):
    """Elementwise-min primary move costs over the primary + flank tables
    (flank ops can substitute for primary ops, context.rs:164-354 + the
    climb quirk)."""
    tables = [
        config.primary_edit_costs,
        config.left_flank_edit_costs,
        config.right_flank_edit_costs,
    ]
    sub = np.minimum.reduce([t.substitution for t in tables])
    step = np.minimum.reduce(
        [np.minimum(t.gap_open, t.gap_extend) for t in tables]
    )
    return sub, step


def _row_suffix_relax(row: np.ndarray, ins_step: np.ndarray) -> np.ndarray:
    """Vectorized right-to-left (min, +) chain: out[j] = min over k >= j of
    row[k] + sum(ins_step[j:k])."""
    # prefix sums of ins_step let the chain become a suffix min of
    # row[k] + P[k], then subtract P[j]; saturate INF.
    q = len(ins_step)
    P = np.concatenate([[0], np.cumsum(ins_step)])
    t = _capmin(row + P)
    suf = np.minimum.accumulate(t[::-1])[::-1]
    out = suf - P
    return np.where(suf >= _BIG, INF, out)


def backward_relaxed(
    sub: np.ndarray,
    step: np.ndarray,
    ref: np.ndarray,
    qry: np.ndarray,
    r_lim: int,
    q_lim: int,
    seed: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Exact backward DP of the relaxed primary graph over the FULL grid.

    B[i, j] = min cost from cell (i, j) to the target (r_lim, q_lim) using
    diagonal (sub[ref[i], qry[j]]), deletion (step[ref[i]]) and insertion
    (step[qry[j]]) moves, optionally also dropping to `seed[i, j]`
    (shortcut landing values).  The grid deliberately extends beyond the
    limits: under NoPrune the primary roams the full sequences and a TSM
    with negative anti-gap can bring an overshot path back inside the
    range, so beyond-limit cells are reachable-from and must carry real
    values (they stay INF exactly when no shortcut seed rescues them)."""
    n_r, n_q = len(ref), len(qry)
    nsym = len(step)
    # Out-of-alphabet characters (the device engines' poison padding char is
    # alphabet.size) take an extra all-INF table row; per-move costs are
    # capped at CLAMP (the engines' own convention: accumulations >= _BIG
    # are infinite) so INF + INF can never overflow int64.
    sub_p = np.full((nsym + 1, nsym + 1), CLAMP, dtype=np.int64)
    sub_p[:nsym, :nsym] = np.minimum(sub, CLAMP)
    step_p = np.full(nsym + 1, CLAMP, dtype=np.int64)
    step_p[:nsym] = np.minimum(step, CLAMP)
    ref = np.clip(ref, 0, nsym)
    qry = np.clip(qry, 0, nsym)
    B = np.full((n_r + 1, n_q + 1), INF, dtype=np.int64)
    B[r_lim, q_lim] = 0
    if seed is not None:
        np.minimum(B, seed, out=B)
    ins_step = step_p[qry] if n_q else np.zeros(0, dtype=np.int64)
    for i in range(n_r, -1, -1):
        row = B[i]
        if i < n_r:
            below = B[i + 1]
            dstep = step_p[ref[i]]
            np.minimum(row, _capmin(below + dstep), out=row)
            if n_q:
                diag = _capmin(sub_p[ref[i], qry] + below[1:])
                np.minimum(row[:n_q], diag, out=row[:n_q])
        if n_q:
            B[i] = _row_suffix_relax(row, ins_step)
    return B


def apply_shortcuts(B: np.ndarray, kernels: List[KindKernel]) -> np.ndarray:
    """S[i, j] = min over kinds of min_{l, ag} K(l, ag) + B(i + dI, j + dJ)
    with (dI, dJ) = (l, ag) for Reference-primary kinds and (ag, l) for
    Query-primary kinds."""
    S = np.full_like(B, INF)
    for k in kernels:
        l_axis = 0 if k.pk == 0 else 1
        ag_axis = 1 - l_axis
        # fold anti(ag) over the ag axis
        Bw = np.full_like(B, INF)
        for a, b, c in k.ag_segments:
            np.minimum(Bw, _capmin(windowed_min(B, a, b, axis=ag_axis) + c), out=Bw)
        # fold sec_step * l + length(l) over the l axis (affine transform)
        n_l = B.shape[l_axis]
        u = np.arange(n_l, dtype=np.int64) * k.sec_step
        u_exp = u[:, None] if l_axis == 0 else u[None, :]
        T = np.where(Bw >= _BIG, INF, Bw + u_exp)
        Sk = np.full_like(B, INF)
        for a, b, c in k.l_segments:
            w = windowed_min(T, a, b, axis=l_axis)
            v = np.where(w >= _BIG, INF, w - u_exp + c)
            np.minimum(Sk, v, out=Sk)
        np.minimum(S, _capmin(Sk + k.const), out=S)
    return S


@dataclass
class RemainingBound:
    """Admissible cost-to-target field B and the one-TSM entry bound S."""

    B: np.ndarray
    S: np.ndarray


def compute_remaining_bound(
    config: TemplateSwitchConfig,
    reference: np.ndarray,
    query: np.ndarray,
    r_lim: int,
    q_lim: int,
    max_iterations: int = 64,
) -> Optional[RemainingBound]:
    """Value-iterate the relaxed graph (primary moves + TSM shortcut kernels)
    to its fixpoint.  Returns None if the iteration does not converge within
    `max_iterations` (pathological configs; callers fall back to the global
    one-TSM delta bound)."""
    ref = np.asarray(reference, dtype=np.int64)
    qry = np.asarray(query, dtype=np.int64)
    kernels = kind_kernels(config, len(ref), len(qry))
    sub, step = relaxed_move_costs(config)
    B = backward_relaxed(sub, step, ref, qry, r_lim, q_lim)
    if not kernels:
        return RemainingBound(B=B, S=np.full_like(B, INF))
    # Value iteration decreases monotonically; it converges whenever the
    # relaxed graph has no reachable negative cycle (guaranteed when every
    # TSM kernel is positive, i.e. any config whose TSMs have nonzero real
    # cost — under the K-scaled tie-break algebra a kernel is then at least
    # K - l_max > 0).  Zero-cost-TSM configs may not converge; bail out and
    # let callers fall back to the global one-TSM delta bound.
    S = apply_shortcuts(B, kernels)
    for _ in range(max_iterations):
        seed = np.minimum(B, S)
        B_next = backward_relaxed(sub, step, ref, qry, r_lim, q_lim, seed=seed)
        if np.array_equal(B_next, B):
            return RemainingBound(B=B, S=S)
        B = B_next
        S = apply_shortcuts(B, kernels)
    return None
