"""TSM kind modules: host tables, module scan, reentry assembly, chunk driver.

Counterpart of ``tsalign_tpu/ops/jax_modules.py``.  Per kind (pk, sk, dk):

  1. the module scan over the secondary length l (`module_scan_torch`, the
     plain form of ``_module_scan_xla``; cross kinds run the CUDA kernel
     through ``ops.module_scan.module_scan`` on the card), emitting the
     per-level exit minima B, over the levels 0..L_read that the assembly's
     windows read (`KindModule.level_tables`; the JAX package scans all L:
     its B's first L_read + 1 levels are these, and no window reads the
     others);
  2. the reentry assembly (`assembly_torch`, the plain form of
     ``_assembly``): shear D3[p2 - l, e, l] + length(l), per finite ldiff
     segment a sliding-window min over s with the anti-gap walk bands and
     kill rows, the ldiff = 0 term, anti(s), then the diagonal min-fold to
     R_pad[p, c + s] (with `separate_cols`, the (n_p+1, C, S) slab of
     each entry column instead); `kind_all_chunks` and `kind_sel_chunks`
     reach it through ``ops.assembly.assembly_fold``, which folds into the
     kind's slab in place and on the card runs ``csrc/assembly.cu`` for a
     chunk's pairs in one launch;
  3. the two chunk drivers, each over one pair or a batch of pairs: the
     chunked route (`kind_all_chunks`, ``_kind_all_chunks``: every live
     chunk of the entry axis) and the compact live-column route
     (`kind_sel_chunks`, ``_kind_sel_chunks(gather=True)``: the live entry
     columns gathered into a power-of-two bucket, each column's slab
     min-folded at its own j2 = e + s); then the fold into the (ref, query)
     reentry field (`fold_kind_cells`).

The TPU workarounds of the JAX package (VMEM and scan-budget chunk clamps,
skew-reshape shears, gather-free masked shifts) are not ported: the chunk
is a plain size, and the assembly indexes directly.  Every fold is a min,
so no value depends on the chunk size.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import TemplateSwitchConfig
from ..convert import tables_from_numpy
from ..costs import INF, CostFunction
from .common import (
    DEV_INF,
    I32,
    check_extension,
    dead_state_threshold,
    device_key,
    full_inf,
    minplus_scan,
    sat_add,
    shift_last,
    sliding_min_start,
    to_device,
    to_device_costs,
)
from .primary import pad_table_for_poison
from .tsm_modules import KindSpec, _dense_or_inf

_DK = ("Forward", "Reverse")
# The module scan's per-level tables (row l: what level l consumes).
LEVEL_NAMES = ("pchar_l", "pmask_l", "io_l", "ie_l")


def _finite_segments(fn: CostFunction, lo: int, hi: int) -> List[Tuple[int, int, int]]:
    """Maximal constant finite segments [(a, b, cost)] of fn over [lo, hi],
    split so that no segment contains 0 (ldiff = 0 is priced separately)."""
    segs = []
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
    out = []
    for a, b, c in segs:
        if a <= 0 <= b:
            if a <= -1:
                out.append((a, -1, c))
            if b >= 1:
                out.append((1, b, c))
        else:
            out.append((a, b, c))
    return out


@dataclass(frozen=True)
class SegPlan:
    """One finite ldiff segment [a, b] of cost `cost` and its static row
    partition: full windows, the anti-gap walk boundary band, killed rows."""

    a: int
    b: int
    cost: int
    positive: bool
    full_rows_end: int
    band_rows: Tuple[int, int]
    kill_from: int


class KindModule:
    """One TSM kind: host tables (numpy) and their tensors per device."""

    def __init__(
        self,
        spec: KindSpec,
        config: TemplateSwitchConfig,
        reference: np.ndarray,
        query: np.ndarray,
        anti_lo: int,
        anti_hi: int,
        chunk: int = 64,
        allow_secondary_deletions: bool = True,
        lut_cache: Optional[dict] = None,
    ):
        self.spec = spec
        self.same_seq = spec.same_seq
        self.dk = spec.dk
        self.chunk = min(chunk, spec.n_anti + 1)
        self.allow_sdel = allow_secondary_deletions
        self.anti_lo, self.anti_hi = anti_lo, anti_hi
        self._tables = {}
        self._b_pre = {}

        ref = np.asarray(reference, dtype=np.int8)
        qry = np.asarray(query, dtype=np.int8)
        P = ref if spec.pk == 0 else qry
        sec = ref if spec.sk == 0 else qry
        A = config.alphabet.size
        comp = np.append(config.alphabet.complement_array().astype(np.int8), A)
        table = pad_table_for_poison(config.secondary_edit_costs(_DK[spec.dk]))

        n_s, r_lo, r_hi = spec.n_s, spec.r_lo, spec.r_hi
        self.W = W = r_hi - r_lo + 1
        bonus = config.secondary_length_bonus
        lut_key = (spec.sk, spec.dk, r_lo, r_hi)
        cached = lut_cache.get(lut_key) if lut_cache is not None else None
        if cached is None:
            b = np.arange(n_s + 1, dtype=np.int32)[:, None]
            r = np.arange(r_lo, r_hi + 1, dtype=np.int32)[None, :]
            cidx = b + r if spec.dk == 0 else b + r - 1
            valid = (cidx >= 0) & (cidx < n_s)
            raw = sec[np.clip(cidx, 0, max(n_s - 1, 0))]
            cvals = comp[raw] if spec.dk == 1 else raw
            schar = np.where(valid, cvals, np.int8(A)).astype(np.int32)
            sub32 = to_device_costs(
                np.where(table.substitution < INF, table.substitution - bonus, INF)
            )
            go32 = to_device_costs(table.gap_open)
            ge32 = to_device_costs(table.gap_extend)
            # (A+1, n_s+1, W) substitution LUT vs the secondary char at (b, r)
            cached = (sub32[:, schar], go32[schar], ge32[schar])
            if lut_cache is not None:
                lut_cache[lut_key] = cached
        self.sub_lut, self.sdel_open, self.sdel_ext = cached
        self.pgap_open = to_device_costs(
            np.where(table.gap_open < INF, table.gap_open - bonus, INF)
        )
        self.pgap_ext = to_device_costs(
            np.where(table.gap_extend < INF, table.gap_extend - bonus, INF)
        )
        self.seed = to_device_costs(spec.seed)

        n_p, L = spec.n_p, spec.l_max
        self.n_p, self.L = n_p, L
        # Per-level primary chars and validity (levels consume P[p1 + l]).
        pb = np.arange((n_s if spec.same_seq else n_p) + 1, dtype=np.int32)
        pidx = pb[None, :] + np.arange(L, dtype=np.int32)[:, None]
        pvalid = pidx < n_p
        self.pchar_l = np.where(
            pvalid, P[np.clip(pidx, 0, max(n_p - 1, 0))].astype(np.int32), 0
        ).astype(np.int32)
        self.pmask_l = np.where(pvalid, 0, DEV_INF).astype(np.int32)
        # From this state minimum on, a problem of the module scan is dead
        # for good and the kernel may leave it (0: never).
        self.skip_from = dead_state_threshold(
            self.sub_lut, self.sdel_open, self.pmask_l, self.pgap_open, self.pgap_ext,
            L, allow_sdel=self.allow_sdel)

        # --- assembly statics ---
        lv = to_device_costs(
            _dense_or_inf(config.length_costs, 0, L)
            if L >= config.length_costs.points[0][0]
            else np.full(L + 1, INF, dtype=np.int64)
        )
        lv[: spec.min_len] = DEV_INF
        self.length_vec = lv

        ldiff_fn = config.length_difference_costs
        dw = ldiff_fn.finite_window()
        d_lo = max(int(dw[0]), -(spec.n_anti + L + 1))
        d_hi = min(int(dw[1]), spec.n_anti + L + 1)
        self.ldiff0 = min(ldiff_fn.evaluate(0), DEV_INF)
        segs = _finite_segments(ldiff_fn, d_lo, d_hi)

        anti_fn = config.anti_primary_gap_costs(_DK[spec.dk])
        s_lo = spec.min_len + min([a for a, _, _ in segs] + [0])
        s_hi = L + max([b for _, b, _ in segs] + [0])
        s_lo = max(s_lo, -spec.n_anti)
        s_hi = min(s_hi, spec.n_anti - 1)  # j2 = e + s <= n_anti-1, e >= 0
        aw = anti_fn.finite_window()
        if aw is not None:
            s_lo = max(s_lo, int(aw[0]))
            s_hi = min(s_hi, int(aw[1]))
        self.active = aw is not None and s_lo <= s_hi
        if not self.active:
            return
        self.s_lo, self.s_hi = s_lo, s_hi
        self.S = s_hi - s_lo + 1
        self.anti_vec = to_device_costs(_dense_or_inf(anti_fn, s_lo, s_hi))

        # l'-axis padding so every window index is in range
        t_min = min([s_lo - sg[1] for sg in segs] + [s_lo, 0])
        t_max = max([s_hi - sg[0] for sg in segs] + [s_hi, L])
        self.OFF = -t_min
        self.LL = t_max - t_min + 1
        # The last level of B that a window or the ldiff = 0 term reads
        # (t_max without its L term): the module scan runs L_read levels
        # (`level_tables`) and the assembly takes B of L_read + 1 levels.
        self.L_read = max(0, min(L, max([s_hi - sg[0] for sg in segs] + [s_hi])))
        Al, Ah = anti_lo, anti_hi
        plans = []
        for a, b2, c in segs:
            if a >= 1:
                # feasible iff p2 + ldiff <= Ah
                plans.append(SegPlan(a, b2, c, True, Ah - b2,
                                     (max(0, Ah - b2 + 1), min(n_p, Ah - a)),
                                     Ah - a + 1))
            else:
                # feasible iff p2 + ldiff >= Al
                plans.append(SegPlan(a, b2, c, False, Al - a,
                                     (max(0, Al - b2), min(n_p, Al - a - 1)),
                                     Al - b2))
        self.plans = tuple(plans)
        # A poison-padded (bucketed) problem: the positive-ldiff exit walk
        # p2 + ldiff <= Ah takes the real anti length, a value of this pair
        # (`assembly_torch`, and the assembly kernel's per-pair `ah`); the
        # shapes and the other plans stay the bucket's, shared by every pair
        # of it.
        self.padded = spec.bucketed
        self.ah_real = min(anti_hi, spec.n_anti_real)

    def host_tables(self) -> dict:
        """The kind's int32 numpy tables, named as ``JaxKindModule._fixed``."""
        return {
            "seed": self.seed,
            "lut": self.sub_lut,
            "sdo": self.sdel_open,
            "sde": self.sdel_ext,
            "pchar_l": self.pchar_l,
            "pmask_l": self.pmask_l,
            "pgo": self.pgap_open,
            "pge": self.pgap_ext,
            "length_vec": self.length_vec,
            "anti_vec": self.anti_vec,
        }

    def tables(self, device) -> dict:
        """The kind's tensors on `device` (built once per device), plus the
        per-level insertion costs io_l/ie_l of the module scan."""
        key = device_key(device)
        if key not in self._tables:
            t = tables_from_numpy(self.host_tables(), device)
            pc = t["pchar_l"].long()
            t["io_l"] = sat_add(t["pgo"][pc], t["pmask_l"])
            t["ie_l"] = sat_add(t["pge"][pc], t["pmask_l"])
            self._tables[key] = t
        return self._tables[key]

    def level_tables(self, device) -> dict:
        """The module scan's per-level tables on `device`, cut to the
        L_read levels whose exit minima the assembly reads: a scan over
        them gives the first L_read + 1 levels of the full scan's B."""
        t = self.tables(device)
        return {n: t[n][: self.L_read] for n in LEVEL_NAMES}

    def same_module(self, device) -> torch.Tensor:
        """Intra-sequence kinds: the module scan is independent of the entry
        field, so it runs once per kind and device (``_same_module_jit``,
        cut to L_read + 1 levels), on the card as the kernel's diagonal
        mode."""
        from .module_scan import module_scan_diag

        key = device_key(device)
        if key not in self._b_pre:
            t = self.tables(device)
            lv = self.level_tables(device)
            self._b_pre[key] = module_scan_diag(
                t["seed"], t["lut"], t["sdo"], t["sde"], *(lv[n] for n in LEVEL_NAMES),
                fwd=self.dk == 0, allow_sdel=self.allow_sdel,
            )
        return self._b_pre[key]


def module_scan_torch(seed0, lut, sdo, sde, pchar_l, pmask_l, io_l, ie_l, *,
                      fwd: bool, allow_sdel: bool):
    """Plain module scan (``_module_scan_xla``).

    Cross kinds: seed0 (NB, C, W), lut (A, C, W), sdo/sde (C, W).
    Same-sequence kinds: seed0 (n_b, W), lut (A, n_b, W), sdo/sde (n_b, W),
    where row b reads lut[pchar[b], b].  Per-level tables (L, NB).
    Returns B (L+1, NB[, C]) int32."""
    L = pchar_l.shape[0]
    same = seed0.dim() == 2
    Tn = seed0.clone()
    Ti = torch.full_like(seed0, DEV_INF)
    Td = torch.full_like(seed0, DEV_INF)
    if allow_sdel:
        check_extension("module_scan_torch", sde)
    ext = shift_last(sde, 1, fwd)
    ex = (slice(None), None) if same else (slice(None), None, None)

    def close(Tn, Ti, Td):
        if not allow_sdel:
            return Td
        cand = shift_last(sat_add(torch.minimum(Tn, Ti), sdo), 1, fwd)
        return minplus_scan(torch.minimum(cand, Td), ext, reverse=not fwd)

    B = torch.empty((L + 1,) + tuple(seed0.shape[:-1]), dtype=I32, device=seed0.device)
    for lvl in range(L + 1):
        Td = close(Tn, Ti, Td)
        src_any = torch.minimum(torch.minimum(Tn, Ti), Td)
        B[lvl] = src_any.amin(dim=-1)
        if lvl == L:
            break
        pchar = pchar_l[lvl].long()
        if same:
            idx = pchar[None, :, None].expand(1, seed0.shape[0], seed0.shape[1])
            sub = torch.gather(lut, 0, idx)[0]
        else:
            sub = lut[pchar]
        sub = sat_add(sub, pmask_l[lvl][ex])
        none_new = shift_last(sat_add(src_any, sub), 1, fwd)
        Ti = torch.minimum(
            sat_add(torch.minimum(Tn, Td), io_l[lvl][ex]),
            sat_add(Ti, ie_l[lvl][ex]),
        )
        Tn = none_new
        Td = torch.full_like(Tn, DEV_INF)
    return B


def _masked_window_min(src, ok_of_u, w: int, S: int):
    """min over window offsets u with ok_of_u(u) of src[..., s + u]."""
    v = None
    for u in range(w):
        term = torch.where(ok_of_u(u), src[..., u : u + S], DEV_INF)
        v = term if v is None else torch.minimum(v, term)
    return v


def _band_masked(km: KindModule, plan: SegPlan, D3pad, b0: int, b1: int):
    """Per-row-width window minima of the anti-gap walk boundary band rows
    [b0, b1] (``jax_modules._band_masked``): offset u of output s reads ldiff
    x = b - u, feasible for row p2 iff p2 + x <= Ah (positive plans) or
    p2 + x >= Al (negative plans)."""
    w = plan.b - plan.a + 1
    t0 = km.OFF + km.s_lo - plan.b
    src = D3pad[b0 : b1 + 1, :, t0 : t0 + km.S + w - 1]
    rows = torch.arange(b0, b1 + 1, device=D3pad.device)[:, None, None]
    if plan.positive:
        lo_u = torch.clamp(rows - (km.anti_hi - plan.b), 0, w)
        return _masked_window_min(src, lambda u: u >= lo_u, w, km.S)
    hi_u = torch.clamp(rows + (plan.b - km.anti_lo), -1, w - 1)
    return _masked_window_min(src, lambda u: u <= hi_u, w, km.S)


def _positive_padded(km: KindModule, plan: SegPlan, D3pad):
    """A positive-ldiff segment of a poison-padded problem
    (``jax_modules._assembly_positive_traced``): row p2's feasible ldiff
    range is [a, min(b, ah - p2)] for the real anti length ah, an
    end-anchored window of width clip(ah - a - p2 + 1, 0, w) over the w
    offsets, empty (killed) past ah - a.  The rows up to ah - b take the
    full window; each row of the band between takes its own width, as a
    running minimum from the window's end read at that width."""
    w = plan.b - plan.a + 1
    S = km.S
    ah = km.ah_real
    t0 = km.OFF + km.s_lo - plan.b
    src = D3pad[:, :, t0 : t0 + S + w - 1]
    val = sliding_min_start(src, w)[..., :S]
    b0, b1 = max(0, ah - plan.b + 1), min(km.n_p, ah - plan.a)
    if b0 <= b1:
        band = src[b0 : b1 + 1]
        width = (ah - plan.a + 1 - torch.arange(b0, b1 + 1, device=src.device))[:, None, None]
        run = band[:, :, w - 1 : w - 1 + S]
        out = torch.where(width == 1, run, DEV_INF)
        for k in range(2, w):
            run = torch.minimum(run, band[:, :, w - k : w - k + S])
            out = torch.where(width == k, run, out)
        val = val.clone()
        val[b0 : b1 + 1] = out
    rows = torch.arange(km.n_p + 1, device=src.device)[:, None, None]
    return torch.where(rows > ah - plan.a, DEV_INF, val)


def assembly_torch(B, A_chunk, km: KindModule, t: dict, separate_cols: bool = False):
    """Reentry assembly of one chunk (static-plan branch of ``_assembly``;
    a poison-padded problem's positive segments take `_positive_padded`).

    B (L'+1, n_p+1, C) for cross kinds or (L'+1, n_p+1) for same-sequence
    kinds, L' >= km.L_read (its levels above L_read are not read); A_chunk
    (n_p+1, C).  Returns R_pad (n_p+1, C + S - 1) for the
    columns j2 = e0 + s_lo ... e0 + C - 1 + s_hi; with `separate_cols`, the
    slab U (n_p+1, C, S) before the diagonal min-fold, U[p, c, s] landing at
    j2 = e_c + s_lo + s (``_assembly``'s compact-column branch)."""
    L, n_p, S = km.L_read, km.n_p, km.S
    C = A_chunk.shape[1]
    dev = A_chunk.device
    B = B[: L + 1]
    if km.same_seq:
        D3 = sat_add(A_chunk[:, :, None], B.T[:, None, :])
    else:
        D3 = B.permute(1, 2, 0)  # (n_p+1, C, L_read+1)
    D3 = sat_add(D3, t["length_vec"][None, None, : L + 1])

    # shear: D3s[p2, e, l] = D3[p2 - l, e, l] (INF where p2 - l < 0)
    src_row = (torch.arange(n_p + 1, device=dev)[:, None]
               - torch.arange(L + 1, device=dev)[None, :])  # (n_p+1, L+1)
    idx = src_row.clamp_min(0)[:, None, :].expand(n_p + 1, C, L + 1)
    D3s = torch.where((src_row >= 0)[:, None, :], torch.gather(D3, 0, idx), DEV_INF)
    D3pad = full_inf((n_p + 1, C, km.LL), dev)  # DEV_INF past level L_read
    D3pad[:, :, km.OFF : km.OFF + L + 1] = D3s

    rows = torch.arange(n_p + 1, device=dev)[:, None, None]
    U = full_inf((n_p + 1, C, S), dev)
    for plan in km.plans:
        if km.padded and plan.positive:
            val = _positive_padded(km, plan, D3pad)
            U = torch.minimum(U, sat_add(val, min(plan.cost, DEV_INF)))
            continue
        w = plan.b - plan.a + 1
        t0 = km.OFF + km.s_lo - plan.b
        val = sliding_min_start(D3pad[:, :, t0 : t0 + S + w - 1], w)[..., :S]
        b0, b1 = plan.band_rows
        if b0 <= b1:
            val = val.clone()
            val[b0 : b1 + 1] = _band_masked(km, plan, D3pad, b0, b1)
        if plan.positive:
            kill = rows > plan.kill_from - 1
        else:
            kill = rows < plan.kill_from
        val = torch.where(kill, DEV_INF, val)
        U = torch.minimum(U, sat_add(val, min(plan.cost, DEV_INF)))
    # ldiff = 0 exact term (always walk-feasible)
    v0 = D3pad[:, :, km.OFF + km.s_lo : km.OFF + km.s_lo + S]
    U = torch.minimum(U, sat_add(v0, km.ldiff0))
    U = sat_add(U, t["anti_vec"][None, None, :])
    if separate_cols:
        return U

    # diagonal min-fold R_pad[p, c + s] = min_c U[p, c, s]
    col = (torch.arange(C, device=dev)[:, None] + torch.arange(S, device=dev)[None, :])
    R_pad = full_inf((n_p + 1, C + S - 1), dev)
    return R_pad.scatter_reduce(
        1, col.reshape(1, -1).expand(n_p + 1, -1), U.reshape(n_p + 1, -1),
        reduce="amin", include_self=True,
    )


def _kind_levels(kms, dev):
    """The per-level tables of a cross kind (its L_read levels) stacked over
    the pairs, and the skipping mode's threshold for all of them (None, 0
    for a same-sequence kind, whose module is the cached diagonal-mode
    scan)."""
    if kms[0].same_seq:
        return None, 0
    lvs = [km.level_tables(dev) for km in kms]
    levels = {n: torch.stack([lv[n] for lv in lvs]) for n in LEVEL_NAMES}
    skips = [km.skip_from for km in kms]
    # each pair's threshold is sound for it, and so is any larger one
    return levels, 0 if 0 in skips else max(skips)


def _chunk_modules(kms, tabs, live, A_chunks, sl: slice, levels, skip_from):
    """Module exit minima B of one chunk for the pairs `live` (their rows
    on the kernel's pair axis): A_chunks[z] is pair live[z]'s (n_p+1, C)
    entry columns, tabs[i] pair i's per-entry tables, whose columns `sl`
    belong to those entry columns."""
    from .module_scan import module_scan

    km0 = kms[0]
    dev = A_chunks[0].device
    if km0.same_seq:
        return [kms[i].same_module(dev) for i in live]
    idx = to_device(live, dev)
    seedT = torch.stack([sat_add(A_chunks[z][:, :, None], tabs[i]["seed"][sl][None])
                         for z, i in enumerate(live)])
    return module_scan(
        seedT,
        torch.stack([tabs[i]["lut"][:, sl] for i in live]),
        torch.stack([tabs[i]["sdo"][sl] for i in live]),
        torch.stack([tabs[i]["sde"][sl] for i in live]),
        *(levels[n].index_select(0, idx) for n in LEVEL_NAMES),
        fwd=km0.dk == 0, allow_sdel=km0.allow_sdel, skip_from=skip_from,
    )


def kind_all_chunks(kms, A_b, eb_b, PAD: int, width: int):
    """All live chunks of one kind (``_kind_all_chunks``) over one pair or a
    batch of pairs (``_kind_map_jit``): for each chunk index, one module scan
    over the pairs for which that chunk is live (their rows gathered onto the
    kernel's pair axis), then the assembly of those pairs, min-folded into
    their padded reentry slabs at columns PAD + e_base + s_lo
    (``ops.assembly.assembly_fold``: one launch on the card).  `kms` are the
    pairs' modules of the kind, A_b (B, n_p+1, n_e) their entry fields in the
    kind's orientation, eb_b (B, chunks) the chunk bases, -1 for a chunk that
    is skipped.  Returns each pair's (n_p+1, width) slab, None where no chunk
    is live."""
    from .assembly import assembly_fold

    km0 = kms[0]
    dev = A_b.device
    C = km0.chunk
    ts = [km.tables(dev) for km in kms]
    slabs = [None] * len(kms)
    levels, skip_from = _kind_levels(kms, dev)
    for ci in range(eb_b.shape[1]):
        live = [i for i in range(len(kms)) if eb_b[i, ci] >= 0]
        if not live:
            continue
        e_base = int(eb_b[live[0], ci])
        sl = slice(e_base, e_base + C)
        A_chunks = [A_b[i, :, sl] for i in live]
        Bs = _chunk_modules(kms, ts, live, A_chunks, sl, levels, skip_from)
        for i in live:
            if slabs[i] is None:
                slabs[i] = full_inf((km0.spec.n_p + 1, width), dev)
        assembly_fold(Bs, A_chunks, [kms[i] for i in live], [ts[i] for i in live],
                      [slabs[i] for i in live], PAD + e_base + km0.s_lo)
    return slabs


def kind_sel_chunks(kms, A_b, e_sel_b, PAD: int, OUTW: int, n_live=None):
    """The compact live-column route of one kind over one pair or a batch of
    pairs (``_kind_sel_chunks(..., gather=True)``, the batch's
    ``_kind_sel_map_jit``).  `kms` are the pairs' modules of the kind, A_b
    (B, n_p+1, n_e) their entry fields in the kind's orientation, e_sel_b
    (B, Kb) each pair's live entry columns, padded with column 0 (a sentinel
    slot re-gathers column 0: a duplicate folded at its own place, or
    infinite where column 0 is pruned, exact either way under a min).

    Each pair's live columns of the entry field and of the kind's per-entry
    tables are gathered by index; the compact axis runs in chunks of C at
    the bases min(i C, Kb - C), each one module-scan launch over the pairs
    (the kernel's pair axis) and one assembly of those pairs
    (``ops.assembly.assembly_fold``), whose column c min-folds its s-slab at
    PAD + e_c + s_lo + s.
    `n_live` (B,), when given, holds each pair's count of live columns: a
    chunk wholly of sentinel slots is not run for that pair.  Returns the
    (B, n_p+1, OUTW) folded slabs, OUTW = PAD + n_anti + 1 + max(0, s_hi)."""
    from .assembly import assembly_fold

    km0 = kms[0]
    dev = A_b.device
    C = km0.chunk
    n_rows = km0.spec.n_p + 1
    e_sel_host = np.asarray(e_sel_b, dtype=np.int64)
    e_sel = to_device(e_sel_host, dev)
    Kb = e_sel.shape[1]
    ts = [km.tables(dev) for km in kms]
    levels, skip_from = _kind_levels(kms, dev)
    A_sel = [A_b[i].index_select(1, e_sel[i]) for i in range(len(kms))]
    if km0.same_seq:
        tabs = ts
    else:
        tabs = [{"seed": t["seed"].index_select(0, e), "lut": t["lut"].index_select(1, e),
                 "sdo": t["sdo"].index_select(0, e), "sde": t["sde"].index_select(0, e)}
                for t, e in zip(ts, e_sel)]
    out = full_inf((len(kms), n_rows, OUTW), dev)
    for e0 in range(0, Kb, C):
        eb = min(e0, Kb - C) if Kb >= C else 0
        live = [i for i in range(len(kms)) if n_live is None or eb < n_live[i]]
        if not live:
            continue
        sl = slice(eb, eb + C)
        A_chunks = [A_sel[i][:, sl] for i in live]
        Bs = _chunk_modules(kms, tabs, live, A_chunks, sl, levels, skip_from)
        assembly_fold(Bs, A_chunks, [kms[i] for i in live], [ts[i] for i in live],
                      [out[i] for i in live], PAD + km0.s_lo, dest=e_sel_host[live, sl])
    return out


def fold_kind_cells(R, Rk_pad, n_real: int, *, PAD: int, n_anti: int,
                    transpose: bool):
    """Fold one kind's padded slab into the (n_r+1, n_q+1) reentry field:
    the real j2 range, the strict reentry bound j2 < n_real, the pk == 1
    transpose, then a min (``_fold_kind_cells``)."""
    Rk = Rk_pad[:, PAD : PAD + n_anti + 1]
    cols = torch.arange(n_anti + 1, device=Rk.device)[None, :]
    Rk = torch.where(cols < n_real, Rk, DEV_INF)
    if transpose:
        Rk = Rk.T
    return torch.minimum(R, Rk)
