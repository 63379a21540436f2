"""Dense template-switch "module" sweeps and reentry assembly (numpy, exact).

A TSM of kind (primary pk, secondary sk, direction dk) is decomposed as:

  entry cell (p1, e_anti)  --base + offset(fo)-->  secondary alignment of
  P[p1 .. p1+l) against Sec around e_s  --length(l) + ldiff + anti(ag)-->
  reentry cell (p2 = p1+l, j2 = e_anti + ag)

where P is the primary (descendant) sequence, Sec the secondary (ancestor)
sequence, e_anti the frozen anti-primary coordinate of the entrance, e_s the
entrance coordinate in Sec (= p1 for intra-sequence kinds RR/QQ, = e_anti for
cross-sequence kinds RQ/QR), fo the first offset, l the secondary length
(primary characters consumed), and ag the anti-primary gap.

This replaces the reference's sparse A* walk over TemplateSwitchEntrance /
Secondary / TemplateSwitchExit states (lib_tsalign/src/a_star_aligner/
template_switch_distance/context.rs:357-729) with:

  1. a *seed vector* realizing the entrance-offset walk semantics exactly,
     including the forward-direction quirk that the first +-1 offset step is
     priced offset(0) (the entrance node pays offset(0) but stands at fo=+-1,
     context.rs:357-374), with walk feasibility telescoped into the
     root-spawn condition (the per-step bounds are monotone along the walk);
  2. a banded module DP over (batch, r) scanned along l, where r = s_idx - e_s
     is the relative secondary index.  Secondary deletions form a directional
     (min,+) chain along r solved with the prefix-scan trick;
  3. a reentry assembly realizing the exit: initial exit requires
     length(l) and ldiff(0) finite (context.rs:622-633), the anti-gap walk is
     priced by telescoped V-shaped ldiff deltas with the reference's
     `primary_index + ldiff` in-bounds proxy (context.rs:662-707), the
     reentry pays anti_primary_gap(ag) and lands strictly inside the
     anti sequence (template_switch_distance.rs:600-618).

All computations saturate at INF using the CLAMP arithmetic from
primary_sweep.  These numpy sweeps are the executable spec for the JAX/Pallas
kernels and are exact against the Dijkstra oracle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..config import TemplateSwitchConfig
from ..costs import INF, CostFunction
from .primary_sweep import CLAMP, GAP_DEL, GAP_INS, GAP_NONE, min_plus_scan, sat_add

_PK = ("Reference", "Query")
_DK = ("Forward", "Reverse")


def _dense_or_inf(fn: CostFunction, lo: int, hi: int) -> np.ndarray:
    """fn evaluated on [lo, hi] inclusive; inputs below domain are INF."""
    out = np.full(hi - lo + 1, INF, dtype=np.int64)
    dom_lo = fn.points[0][0]
    for k, x in enumerate(range(lo, hi + 1)):
        if x >= dom_lo:
            out[k] = fn.evaluate(x)
    return out


def real_seq_length(seq: np.ndarray, alphabet_size: int) -> int:
    """Content length of a possibly poison-suffix-padded sequence: the
    index of the first poison char (== alphabet_size), or len(seq)."""
    s = np.asarray(seq)
    hits = np.nonzero(s >= alphabet_size)[0]
    return int(hits[0]) if hits.size else len(s)


@dataclass
class KindSpec:
    """Static description of one TSM kind's dense module."""

    pk: int  # 0 = Reference primary, 1 = Query primary
    sk: int
    dk: int  # 0 = Forward, 1 = Reverse
    base: int
    same_seq: bool  # sk == pk: e_s = p1; else e_s = e_anti
    n_p: int
    n_s: int
    n_anti: int
    min_len: int
    l_max: int
    r_lo: int
    r_hi: int
    seed: np.ndarray  # (n_s+1, W): entrance cost at (b = e_s, r = fo), INF-masked
    # Real (pre-poison-padding) lengths.  Shapes and windows above derive
    # from the padded lengths so equal-shaped bucketed problems share
    # compiled programs; every STRUCTURAL feasibility (root-spawn walk
    # bounds, strict reentry j2 < n_anti, exit anti-gap walk bounds) must
    # use these instead — the padded lengths would otherwise widen the
    # reachable state space beyond the real problem's (padding is only
    # sound for char-touching ops, which the poison tables price INF).
    n_s_real: int = -1
    n_anti_real: int = -1
    # True when the caller passed explicit real lengths (bucketed problem):
    # the device pipeline then uses the traced-bound machinery even when a
    # pair's real length coincides with the bucket, so a bucket's programs
    # and stacked pytrees stay uniform.
    bucketed: bool = False

    def __post_init__(self):
        if self.n_s_real < 0:
            self.n_s_real = self.n_s
        if self.n_anti_real < 0:
            self.n_anti_real = self.n_anti


def make_kind_spec(
    config: TemplateSwitchConfig,
    n_ref: int,
    n_qry: int,
    pk: int,
    sk: int,
    dk: int,
    sdel_budget: Optional[int] = None,
    n_ref_real: Optional[int] = None,
    n_qry_real: Optional[int] = None,
) -> Optional[KindSpec]:
    """Build the static spec for one kind, or None if the kind is inactive.

    n_ref/n_qry may be poison-padded lengths (bucketed batch/chain
    problems); n_*_real are then the real content lengths.  Shapes, windows
    and the active/inactive decision derive from the padded lengths (so all
    problems in a bucket agree); the seed feasibility mask uses the real
    lengths (root-spawn walk bounds telescope against the real secondary
    end, template_switch_distance.rs:241-327)."""
    base = config.get_base_cost(_PK[pk], _PK[sk], _DK[dk])
    offset_fn = config.offset_costs(_PK[pk], _PK[sk])
    length_fn = config.length_costs
    ldiff_fn = config.length_difference_costs

    n_p = n_ref if pk == 0 else n_qry
    n_s = n_ref if sk == 0 else n_qry
    n_anti = n_qry if pk == 0 else n_ref
    bucketed = n_ref_real is not None or n_qry_real is not None
    n_ref_real = n_ref if n_ref_real is None else n_ref_real
    n_qry_real = n_qry if n_qry_real is None else n_qry_real
    n_s_real = n_ref_real if sk == 0 else n_qry_real
    n_anti_real = n_qry_real if pk == 0 else n_ref_real

    if base >= INF or n_p == 0 or n_s == 0 or n_anti == 0:
        return None
    off0 = offset_fn.evaluate(0)
    if off0 >= INF:
        return None
    # Initial exit requires ldiff(0) finite (context.rs:622-633).
    if ldiff_fn.evaluate(0) >= INF:
        return None
    min_len = length_fn.minimum_finite_input()
    if min_len is None:
        return None
    l_max_cfg = length_fn.maximum_finite_input()
    l_max = n_p if l_max_cfg is None else min(int(l_max_cfg), n_p)
    if l_max < min_len or min_len > n_s:
        return None

    ow = offset_fn.finite_window()
    if ow is None:
        return None
    off_lo = max(int(ow[0]), -n_s)
    off_hi = min(int(ow[1]), n_s)
    if off_lo > off_hi:
        return None

    # Secondary deletions drift r beyond the offset window; bound the drift by
    # the cost budget (each deletion costs >= the table's cheapest gap step).
    if sdel_budget is None:
        drift = n_s
    else:
        drift = min(int(sdel_budget), n_s)
    if dk == 0:  # forward: r never decreases
        r_lo, r_hi = off_lo, min(off_hi + l_max + drift, n_s)
    else:  # reverse: r never increases
        r_lo, r_hi = max(off_lo - l_max - drift, -n_s), off_hi
    r_lo = max(r_lo, -n_s)
    r_hi = min(r_hi, n_s)
    if r_lo > r_hi:
        return None

    W = r_hi - r_lo + 1
    b = np.arange(n_s + 1)[:, None]  # e_s entrance coordinate
    r = np.arange(r_lo, r_hi + 1)[None, :]
    offd = _dense_or_inf(offset_fn, r_lo, r_hi)[None, :]

    if dk == 1:
        # Reverse: seed at fo=0 costs base+offset(0); the walk telescopes so a
        # root at fo costs base+offset(fo).  Feasible iff
        # min_len <= e_s + fo <= n_s (walk conditions telescope to this).
        cost = sat_add(np.full_like(offd, base), offd)
        cost = np.broadcast_to(cost, (n_s + 1, W)).copy()
        feasible = (b + r >= min_len) & (b + r <= n_s_real)
    else:
        # Forward: seeds at fo=+-1 cost base+offset(0) (quirk); farther
        # offsets add telescoped deltas offset(fo)-offset(sign(fo)).
        cost = np.full((1, W), INF, dtype=np.int64)
        off_p1 = offset_fn.evaluate(1) if 1 >= offset_fn.points[0][0] else INF
        off_m1 = offset_fn.evaluate(-1) if -1 >= offset_fn.points[0][0] else INF
        near = np.abs(r[0]) == 1
        cost[0, near] = sat_add(base, off0)
        far_up = r[0] >= 2
        far_dn = r[0] <= -2
        # V-shape guarantees offset(fo) >= offset(sign(fo)), so the delta is
        # non-negative; an INF offset(fo) blocks the walk.
        up = np.where(
            (offd[0] < INF) & (off_p1 < INF),
            base + off0 + offd[0] - (off_p1 if off_p1 < INF else 0),
            INF,
        )
        dn = np.where(
            (offd[0] < INF) & (off_m1 < INF),
            base + off0 + offd[0] - (off_m1 if off_m1 < INF else 0),
            INF,
        )
        cost[0, far_up] = up[far_up]
        cost[0, far_dn] = dn[far_dn]
        cost = np.broadcast_to(cost, (n_s + 1, W)).copy()
        feasible = (b + r >= 0) & (b + r + min_len <= n_s_real) & (r != 0)

    seed = np.where(feasible, cost, INF)
    if not (seed < INF).any():
        # Bucketed problems must keep the kind-set uniform across pairs
        # (the batched path stacks per-pair tensors): gate activity on the
        # PADDED feasibility (shared across the bucket) and let the
        # all-INF real seed make this pair's module a no-op.
        if not bucketed:
            return None
        feas_pad = (
            (b + r >= min_len) & (b + r <= n_s)
            if dk == 1
            else (b + r >= 0) & (b + r + min_len <= n_s) & (r != 0)
        )
        if not (np.where(feas_pad, cost, INF) < INF).any():
            return None

    return KindSpec(
        pk=pk,
        sk=sk,
        dk=dk,
        base=base,
        same_seq=(pk == sk),
        n_p=n_p,
        n_s=n_s,
        n_anti=n_anti,
        min_len=min_len,
        l_max=l_max,
        r_lo=r_lo,
        r_hi=r_hi,
        seed=seed,
        n_s_real=n_s_real,
        n_anti_real=n_anti_real,
        bucketed=bucketed,
    )


class ModuleSweep:
    """Dense secondary-phase DP for one kind.

    For intra-sequence kinds (RR/QQ) the module batch axis is p1 (= e_s) and
    the result is B[p1, l] = cheapest secondary alignment of length l starting
    at p1 (entry cost A is added later in the assembly).  For cross-sequence
    kinds (RQ/QR) the batch axes are (p1, e_anti = e_s) and the entry field A
    is folded into the seeds, yielding B2[p1, e_anti, l].
    """

    def __init__(
        self,
        spec: KindSpec,
        config: TemplateSwitchConfig,
        reference: np.ndarray,
        query: np.ndarray,
        allow_secondary_deletions: bool = True,
    ):
        self.spec = spec
        self.config = config
        self.allow_sdel = allow_secondary_deletions
        ref = np.asarray(reference, dtype=np.int64)
        qry = np.asarray(query, dtype=np.int64)
        self.P = ref if spec.pk == 0 else qry
        sec = ref if spec.sk == 0 else qry
        # Poison padding char support (bucketed batch/chain problems): the
        # complement of poison is poison and its padded table row/column
        # prices INF, so any op touching padding is infeasible.
        A = config.alphabet.size
        comp = np.append(
            config.alphabet.complement_array().astype(np.int64), A
        )
        from .primary import pad_table_for_poison as _pad_table_for_poison

        table = _pad_table_for_poison(config.secondary_edit_costs(_DK[spec.dk]))

        n_s, r_lo, r_hi = spec.n_s, spec.r_lo, spec.r_hi
        W = r_hi - r_lo + 1
        b = np.arange(n_s + 1)[:, None]
        r = np.arange(r_lo, r_hi + 1)[None, :]
        if spec.dk == 0:
            # Forward: at state r the next secondary char is Sec[b + r].
            cidx = b + r
            valid = (cidx >= 0) & (cidx < n_s)
            schar = np.where(valid, sec[np.clip(cidx, 0, max(n_s - 1, 0))], 0)
        else:
            # Reverse: at state r the next secondary char is comp(Sec[b+r-1]).
            cidx = b + r - 1
            valid = (cidx >= 0) & (cidx < n_s)
            schar = np.where(valid, comp[sec[np.clip(cidx, 0, max(n_s - 1, 0))]], 0)
        self.schar = schar  # (n_s+1, W) char consumed when stepping out of r
        self.svalid = valid
        mask = np.where(valid, 0, INF)
        # Gap costs for consuming the secondary char at state r.
        self.sdel_open = np.where(valid, table.gap_open[schar], INF)
        self.sdel_ext = np.where(valid, table.gap_extend[schar], INF)
        bonus = config.secondary_length_bonus
        self.sub_table = np.where(
            table.substitution < INF, table.substitution - bonus, INF
        )
        self.pgap_open = np.where(table.gap_open < INF, table.gap_open - bonus, INF)
        self.pgap_ext = np.where(table.gap_extend < INF, table.gap_extend - bonus, INF)
        self.mask = mask
        self.W = W

    def _sdel_close(
        self,
        T: np.ndarray,
        sdel_open: Optional[np.ndarray] = None,
        sdel_ext: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Apply the secondary-deletion chain along r in place; returns T.

        T has shape (3, ..., W).  Deletions move r by +1 (forward) / -1
        (reverse); open from NONE/INS, extend from DEL, costs keyed by the
        consumed char at the source state.  `sdel_open`/`sdel_ext` default to
        the dense per-(b, r) tables; the compacted cross sweep passes
        per-live-pair gathers instead.
        """
        if not self.allow_sdel:
            return T
        if sdel_open is None:
            sdel_open, sdel_ext = self.sdel_open, self.sdel_ext
        spec = self.spec
        flip = spec.dk == 1
        open_src = np.minimum(T[GAP_NONE], T[GAP_INS])
        if not flip:
            # into r from r-1
            cand = np.full_like(T[GAP_DEL], INF)
            cand[..., 1:] = sat_add(open_src[..., :-1], sdel_open[..., :-1])
            ext_into = np.full_like(T[GAP_DEL], INF)
            ext_into[..., 1:] = sdel_ext[..., :-1]
            cand = np.minimum(cand, T[GAP_DEL])
            ext_into[..., 0] = CLAMP
            T[GAP_DEL] = min_plus_scan(cand, ext_into, axis=-1)
        else:
            cand = np.full_like(T[GAP_DEL], INF)
            cand[..., :-1] = sat_add(open_src[..., 1:], sdel_open[..., 1:])
            ext_into = np.full_like(T[GAP_DEL], INF)
            ext_into[..., :-1] = sdel_ext[..., 1:]
            cand = np.minimum(cand, T[GAP_DEL])
            ext_into[..., -1] = CLAMP
            T[GAP_DEL] = _flip_scan(cand, ext_into)
        return T

    def sweep(self, A_mod: Optional[np.ndarray] = None) -> np.ndarray:
        """Run the module scan.

        Returns B[p1, l] (same_seq, A not folded) or B2[p1, e_anti, l]
        (cross kinds, requires A_mod[p1, e_anti]).
        """
        spec = self.spec
        n_s, W = spec.n_s, self.W
        L = spec.l_max

        if not spec.same_seq:
            return self._sweep_cross(A_mod)
        if getattr(self, "_b_cache", None) is not None:
            return self._b_cache

        # batch axis b doubles as p1 (n_p == n_s).
        T = np.full((3, n_s + 1, W), INF, dtype=np.int64)
        T[GAP_NONE] = spec.seed
        B = np.full((n_s + 1, L + 1), INF, dtype=np.int64)
        p_of_b = np.arange(n_s + 1)
        n_p = spec.n_p

        for level in range(L + 1):
            T = self._sdel_close(T)
            B[..., level] = T.min(axis=0).min(axis=-1)
            if level == L:
                break
            # transitions to level+1 consume primary char P[p1 + level]
            pidx = p_of_b + level
            pvalid = pidx < n_p
            pchar = np.where(pvalid, self.P[np.clip(pidx, 0, max(n_p - 1, 0))], 0)
            pmask = np.where(pvalid, 0, INF)
            # match/substitution: also consumes the secondary char at source r
            src_any = T.min(axis=0)
            sub = sat_add(
                sat_add(self.sub_table[pchar[..., None], self.schar], self.mask),
                pmask[..., None],
            )
            diag = sat_add(src_any, sub)
            newT = np.full_like(T, INF)
            if spec.dk == 0:
                newT[GAP_NONE, ..., 1:] = diag[..., :-1]
            else:
                newT[GAP_NONE, ..., :-1] = diag[..., 1:]
            # secondary insertion: consumes primary char only, r unchanged
            io = sat_add(self.pgap_open[pchar], pmask)[..., None]
            ie = sat_add(self.pgap_ext[pchar], pmask)[..., None]
            newT[GAP_INS] = np.minimum(
                sat_add(np.minimum(T[GAP_NONE], T[GAP_DEL]), io),
                sat_add(T[GAP_INS], ie),
            )
            T = newT

        # Entry-independent (keyed by p1 only), hence round-invariant.
        self._b_cache = B
        return B

    def _gbound(self, landing_min: int):
        """Admissible per-level completion bound for the threshold prune:
        g[level] = landing_min + min over final lengths l >= level of
        (l - level) * s0 + Wmin[l], where Wmin[l] is the cheapest exit
        pricing at length l and s0 = min(0, cheapest primary-consuming
        secondary step).  A module state at `level` with value v can only
        contribute a reentry whose completed path costs >= v + g[level]."""
        if getattr(self, "_g_cache", None) is not None:
            return self._g_cache
        spec, config = self.spec, self.config
        L = spec.l_max
        w = _exit_window(spec, config)
        s0 = 0
        if w is None:
            g = np.full(L + 2, CLAMP, dtype=np.int64)
        else:
            W = _exit_kernel(spec, config, *w)
            Wmin = np.minimum(W, CLAMP).min(axis=1)
            steps = [
                arr[arr < CLAMP]
                for arr in (self.sub_table, self.pgap_open, self.pgap_ext)
            ]
            fin = [int(a.min()) for a in steps if a.size]
            s0 = min(0, min(fin)) if fin else 0
            g = np.full(L + 2, CLAMP, dtype=np.int64)
            for level in range(L, -1, -1):
                g[level] = min(Wmin[level], min(g[level + 1] + s0, CLAMP))
        g = np.minimum(g + min(landing_min, CLAMP), CLAMP)
        self._g_cache = (g, s0)
        return self._g_cache

    def sweep_sparse(
        self,
        A_mod: np.ndarray,
        landing_min: Optional[int] = None,
        best: int = INF,
    ):
        """Sparse module output: (p1s, es, ls, vals) triples of
        D3[p1, e_anti, l] = entry + module cost, restricted to finite
        entries.  Returns None when entry occupancy is too high for the
        sparse route to win (callers fall back to the dense sweep).

        With `landing_min`/`best`, states and outputs provably above the
        incumbent (value + completion bound > best) are dropped level by
        level — the module work then tracks the surviving frontier instead
        of the full (live pairs x r-window x length) volume."""
        spec = self.spec
        n_p, n_s = spec.n_p, spec.n_s
        prune = None
        if landing_min is not None and best < INF:
            prune = (self._gbound(landing_min), best)
        if spec.same_seq:
            live = A_mod < CLAMP
            if int(live.sum()) * 4 > (n_p + 1) * (n_s + 1):
                return None
            B = self.sweep()  # (n_p+1, L+1): module cost keyed by p1
            p1s, es = np.nonzero(live)
            Bsub = B[p1s]  # (T, L+1)
            t_idx, ls = np.nonzero(Bsub < CLAMP)
            vals = A_mod[p1s, es][t_idx] + Bsub[t_idx, ls]
            # (exact per-length/per-row pruning happens in
            # assemble_reentry_sparse; the same-seq module table is
            # entry-independent and cached, so there is nothing to save here)
            return p1s[t_idx], es[t_idx], ls, vals
        seed_any = (spec.seed < CLAMP).any(axis=-1)
        live = (A_mod < CLAMP) & seed_any[None, :]
        if int(live.sum()) * 4 > (n_p + 1) * (n_s + 1):
            return None
        return self._sweep_cross(A_mod, sparse=True, prune=prune)

    def _sweep_cross(
        self,
        A_mod: Optional[np.ndarray],
        sparse: bool = False,
        prune=None,
    ):
        """Cross-sequence module scan, compacted to live (p1, b) pairs.

        The module DP is elementwise over (entry primary p1, secondary start
        b) — only the r axis couples states — so pairs whose entry value is
        infinite (most of the grid once TSLB pruning has masked the entry
        field) are dropped up front instead of carrying full (n_p, n_s, W)
        temporaries through every level.
        """
        if A_mod is None:
            raise ValueError("cross-sequence module requires the entry field")
        spec = self.spec
        n_p, n_s, W = spec.n_p, spec.n_s, self.W
        L = spec.l_max
        seed_any = (spec.seed < CLAMP).any(axis=-1)
        live = (A_mod < CLAMP) & seed_any[None, :]
        p_idx, b_idx = np.nonzero(live)
        if not sparse:
            B = np.full((n_p + 1, n_s + 1, L + 1), INF, dtype=np.int64)
        if p_idx.size == 0:
            if sparse:
                z = np.zeros(0, dtype=np.int64)
                return z, z, z, z
            return B
        out_p, out_b, out_l, out_v = [], [], [], []
        T = np.full((3, p_idx.size, W), INF, dtype=np.int64)
        T[GAP_NONE] = sat_add(A_mod[p_idx, b_idx][:, None], spec.seed[b_idx])
        schar = self.schar[b_idx]
        smask = self.mask[b_idx]
        so = self.sdel_open[b_idx] if self.allow_sdel else None
        se = self.sdel_ext[b_idx] if self.allow_sdel else None
        if sparse and prune is not None:
            (g, s0), best_cap = prune
        else:
            g, s0, best_cap = None, 0, None

        for level in range(L + 1):
            T = self._sdel_close(T, so, se)
            vmin = T.min(axis=0).min(axis=-1)
            if sparse:
                sel = vmin < CLAMP
                if sel.any():
                    out_p.append(p_idx[sel])
                    out_b.append(b_idx[sel])
                    out_l.append(np.full(int(sel.sum()), level, dtype=np.int64))
                    out_v.append(vmin[sel])
            else:
                B[p_idx, b_idx, level] = vmin
            if level == L:
                break
            if g is not None:
                # Threshold compaction: a pair whose best state cannot
                # complete any future-length TSM within the incumbent is
                # dead for all remaining levels.  Future value at length
                # l > level is >= vmin + (l - level) * s0, so the total is
                # >= vmin + s0 + g[level + 1] (g includes the landing-field
                # minimum); everything capped at CLAMP so the sum is safe.
                alive = np.minimum(vmin, CLAMP) + (s0 + g[level + 1]) <= best_cap
                if not alive.all():
                    if not alive.any():
                        break
                    p_idx, b_idx = p_idx[alive], b_idx[alive]
                    T = np.ascontiguousarray(T[:, alive])
                    schar, smask = schar[alive], smask[alive]
                    if so is not None:
                        so, se = so[alive], se[alive]
            pidx = p_idx + level
            pvalid = pidx < n_p
            pchar = np.where(pvalid, self.P[np.clip(pidx, 0, max(n_p - 1, 0))], 0)
            pmask = np.where(pvalid, 0, INF)
            src_any = T.min(axis=0)
            sub = sat_add(
                sat_add(self.sub_table[pchar[:, None], schar], smask),
                pmask[:, None],
            )
            diag = sat_add(src_any, sub)
            newT = np.full_like(T, INF)
            if spec.dk == 0:
                newT[GAP_NONE, :, 1:] = diag[:, :-1]
            else:
                newT[GAP_NONE, :, :-1] = diag[:, 1:]
            io = sat_add(self.pgap_open[pchar], pmask)[:, None]
            ie = sat_add(self.pgap_ext[pchar], pmask)[:, None]
            newT[GAP_INS] = np.minimum(
                sat_add(np.minimum(T[GAP_NONE], T[GAP_DEL]), io),
                sat_add(T[GAP_INS], ie),
            )
            T = newT

        if sparse:
            if not out_p:
                z = np.zeros(0, dtype=np.int64)
                return z, z, z, z
            return (
                np.concatenate(out_p),
                np.concatenate(out_b),
                np.concatenate(out_l),
                np.concatenate(out_v),
            )
        return B


def _flip_scan(cand: np.ndarray, ext_into: np.ndarray) -> np.ndarray:
    f = min_plus_scan(cand[..., ::-1], ext_into[..., ::-1], axis=-1)
    return f[..., ::-1]


def assemble_reentry(
    spec: KindSpec,
    config: TemplateSwitchConfig,
    D3: np.ndarray,
    anti_lo: int,
    anti_hi: int,
) -> np.ndarray:
    """Combine exit pricing into the reentry field.

    D3[p1, e_anti, l] = entry + module cost (A already folded in).  Returns
    R[p2, j2] over the module's (primary, anti) coordinates; the caller
    transposes for pk = Query.

    Exit semantics (context.rs:622-707, template_switch_distance.rs:579-644):
      cost += length(l) + ldiff(ag - l) + anti_gap(ag)
      walk feasibility: ldiff == 0, or 0 < ldiff <= anti_hi - p2, or
                        anti_lo - p2 <= ldiff < 0
      reentry: j2 = e_anti + ag with 0 <= j2 < n_anti (strict).
    """
    n_p, n_anti = spec.n_p, spec.n_anti
    length_fn = config.length_costs
    ldiff_fn = config.length_difference_costs
    anti_fn = config.anti_primary_gap_costs(_DK[spec.dk])

    dw = ldiff_fn.finite_window()
    if dw is None:
        return np.full((n_p + 1, n_anti + 1), INF, dtype=np.int64)
    d_lo, d_hi = max(int(dw[0]), -2 * max(n_p, n_anti) - 1), min(int(dw[1]), 2 * max(n_p, n_anti) + 1)

    R = np.full((n_p + 1, n_anti + 1), INF, dtype=np.int64)
    p2_axis = np.arange(n_p + 1)

    for l in range(spec.min_len, spec.l_max + 1):
        lc = length_fn.evaluate(l)
        if lc >= INF:
            continue
        base = D3[: n_p + 1 - l, :, l]  # indexed by p1 = p2 - l
        if not (base < CLAMP).any():
            continue
        for ldiff in range(d_lo, d_hi + 1):
            ag = l + ldiff
            if ag < anti_fn.points[0][0]:
                continue
            ac = anti_fn.evaluate(ag)
            dc = ldiff_fn.evaluate(ldiff)
            if ac >= INF or dc >= INF:
                continue
            cost_k = lc + dc + ac
            # walk feasibility per reentry row p2
            p2 = p2_axis[l:]
            if ldiff > 0:
                ok_rows = p2 + ldiff <= anti_hi
            elif ldiff < 0:
                ok_rows = p2 + ldiff >= anti_lo
            else:
                ok_rows = np.ones_like(p2, dtype=bool)
            # reentry column j2 = e_anti + ag, 0 <= j2 < n_anti (real
            # content length under poison padding — strict reentry)
            j2_lo = max(ag, 0)
            j2_hi = min(n_anti + ag, spec.n_anti_real - 1)
            if j2_lo > j2_hi:
                continue
            e_lo = j2_lo - ag
            e_hi = j2_hi - ag
            vals = sat_add(base[:, e_lo : e_hi + 1], np.int64(cost_k))
            vals = np.where(ok_rows[:, None], vals, INF)
            tgt = R[l:, j2_lo : j2_hi + 1]
            np.minimum(tgt, vals, out=tgt)
    return R


def _exit_window(spec: KindSpec, config: TemplateSwitchConfig):
    """(d_lo, d_hi) clamped ldiff window, or None when no exit is finite."""
    dw = config.length_difference_costs.finite_window()
    if dw is None:
        return None
    n_p, n_anti = spec.n_p, spec.n_anti
    m = 2 * max(n_p, n_anti) + 1
    return max(int(dw[0]), -m), min(int(dw[1]), m)


def _exit_kernel(spec: KindSpec, config: TemplateSwitchConfig, d_lo: int, d_hi: int):
    """W[l, di] = length(l) + ldiff(d_lo + di) + anti(l + d_lo + di), the
    full exit pricing per (length, ldiff) pair (INF where infeasible)."""
    length_fn = config.length_costs
    ldiff_fn = config.length_difference_costs
    anti_fn = config.anti_primary_gap_costs(_DK[spec.dk])
    n_d = d_hi - d_lo + 1
    W = np.full((spec.l_max + 1, n_d), INF, dtype=np.int64)
    dcs = np.array(
        [ldiff_fn.evaluate(d) for d in range(d_lo, d_hi + 1)], dtype=np.int64
    )
    a_lo = int(anti_fn.points[0][0])
    for l in range(spec.min_len, spec.l_max + 1):
        lc = length_fn.evaluate(l)
        if lc >= INF:
            continue
        acs = np.array(
            [
                anti_fn.evaluate(l + d) if l + d >= a_lo else INF
                for d in range(d_lo, d_hi + 1)
            ],
            dtype=np.int64,
        )
        row = np.minimum(lc + np.minimum(dcs, CLAMP) + np.minimum(acs, CLAMP), INF)
        W[l] = np.where((dcs < INF) & (acs < INF), row, INF)
    return W


def assemble_reentry_sparse(
    spec: KindSpec,
    config: TemplateSwitchConfig,
    p1s: np.ndarray,
    es: np.ndarray,
    ls: np.ndarray,
    vals: np.ndarray,
    anti_lo: int,
    anti_hi: int,
    landing_bound: Optional[np.ndarray] = None,
    best: int = INF,
) -> np.ndarray:
    """assemble_reentry over sparse (p1, e_anti, l) -> value triples.

    With TSLB-pruned entries the module output is almost entirely infinite;
    pricing every ldiff for the finite triples against the precomputed exit
    kernel in one broadcast (then scatter-min) replaces the dense
    O(|l window| * |ldiff window|) full-grid loop.  Semantics identical to
    assemble_reentry (context.rs:622-707).

    `landing_bound` (module orientation, (n_p+1, n_anti+1)): admissible
    cost-to-target from each reentry cell (lower_bounds.py).  With an
    incumbent `best`, a triple whose cheapest completed TSM plus cheapest
    landing completion exceeds best cannot lie on an optimal or co-optimal
    path and is dropped before the (triple x ldiff) expansion — the
    dominant cost at real-locus scale."""
    n_p, n_anti = spec.n_p, spec.n_anti
    R = np.full((n_p + 1, n_anti + 1), INF, dtype=np.int64)
    w = _exit_window(spec, config)
    if w is None:
        return R
    d_lo, d_hi = w
    keep = (ls >= spec.min_len) & (p1s + ls <= n_p)
    p1s, es, ls, vals = p1s[keep], es[keep], ls[keep], vals[keep]
    if p1s.size == 0:
        return R
    W = _exit_kernel(spec, config, d_lo, d_hi)
    if landing_bound is not None and best < INF and p1s.size:
        Wmin = np.minimum(W, CLAMP).min(axis=1)
        Brmin = np.minimum(landing_bound, CLAMP).min(axis=1)
        lb_tot = np.minimum(vals, CLAMP) + Wmin[ls] + Brmin[p1s + ls]
        keep = lb_tot <= best
        p1s, es, ls, vals = p1s[keep], es[keep], ls[keep], vals[keep]
        if p1s.size == 0:
            return R
    Wl = W[ls]  # (T, n_d)
    tot = vals[:, None] + np.minimum(Wl, CLAMP)
    p2 = p1s + ls
    ld = np.arange(d_lo, d_hi + 1, dtype=np.int64)[None, :]
    feas = (
        (ld == 0)
        | ((ld > 0) & (p2[:, None] + ld <= anti_hi))
        | ((ld < 0) & (p2[:, None] + ld >= anti_lo))
    )
    feas &= Wl < INF
    j2 = es[:, None] + ls[:, None] + ld  # e + ag, ag = l + ldiff
    feas &= (j2 >= 0) & (j2 < spec.n_anti_real)
    flat = np.where(feas, p2[:, None] * (n_anti + 1) + j2, R.size)
    sink = np.append(R.reshape(-1), INF)
    np.minimum.at(sink, flat.reshape(-1), np.where(feas, tot, INF).reshape(-1))
    return sink[:-1].reshape(n_p + 1, n_anti + 1)


def compute_reentry_fields(
    config: TemplateSwitchConfig,
    reference: np.ndarray,
    query: np.ndarray,
    entry_field: np.ndarray,
    anti_bounds_ref: Tuple[int, int],
    anti_bounds_qry: Tuple[int, int],
    sdel_budget: Optional[int] = None,
    allow_secondary_deletions: bool = True,
    allowed_primaries=(0, 1),
    cache: Optional[dict] = None,
    landing_bound: Optional[np.ndarray] = None,
    best: int = INF,
) -> np.ndarray:
    """All-kinds reentry field in (ref, query) cell coordinates.

    entry_field[i, j]: cost of the cheapest flank-L Primary state at cell
    (i, j) (min over gap types).  anti_bounds_*: the (lo, hi) walk bounds for
    the anti-primary coordinate (the primary range under RangePrune, else the
    full sequences).  Returns R_cells[i, j] = cheapest reentry cost, to be
    seeded into the next primary sweep at flank -R, gap None.

    `cache`: round-invariant per-alignment state (ModuleSweep tables and the
    entry-independent same-seq module fields), keyed by kind — callers pass
    a dict that lives as long as the (config, pair, budget) triple.
    """
    n_r, n_q = len(reference), len(query)
    n_r_real = real_seq_length(reference, config.alphabet.size)
    n_q_real = real_seq_length(query, config.alphabet.size)
    out = np.full((n_r + 1, n_q + 1), INF, dtype=np.int64)
    for pk in allowed_primaries:
        A_mod = entry_field if pk == 0 else entry_field.T
        anti_lo, anti_hi = anti_bounds_qry if pk == 0 else anti_bounds_ref
        for sk in (0, 1):
            for dk in (0, 1):
                spec = make_kind_spec(
                    config, n_r, n_q, pk, sk, dk, sdel_budget=sdel_budget,
                    n_ref_real=n_r_real, n_qry_real=n_q_real,
                )
                if spec is None:
                    continue
                key = (pk, sk, dk)
                ms = cache.get(key) if cache is not None else None
                if ms is None:
                    ms = ModuleSweep(
                        spec,
                        config,
                        reference,
                        query,
                        allow_secondary_deletions=allow_secondary_deletions,
                    )
                    if cache is not None:
                        cache[key] = ms
                B_mod = (
                    landing_bound
                    if (landing_bound is None or pk == 0)
                    else landing_bound.T
                )
                landing_min = (
                    int(np.minimum(B_mod, CLAMP).min())
                    if B_mod is not None
                    else None
                )
                sp = ms.sweep_sparse(A_mod, landing_min=landing_min, best=best)
                if sp is not None:
                    R = assemble_reentry_sparse(
                        spec, config, *sp, anti_lo, anti_hi,
                        landing_bound=B_mod, best=best,
                    )
                elif spec.same_seq:
                    B = ms.sweep()
                    D3 = sat_add(A_mod[:, :, None], B[:, None, :])
                    R = assemble_reentry(spec, config, D3, anti_lo, anti_hi)
                else:
                    D3 = ms.sweep(A_mod=A_mod)
                    R = assemble_reentry(spec, config, D3, anti_lo, anti_hi)
                if pk == 1:
                    R = R.T
                np.minimum(out, R, out=out)
    return out
