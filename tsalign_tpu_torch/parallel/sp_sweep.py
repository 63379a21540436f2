"""Sequence-parallel (sharded-wavefront) primary sweeps.

The port's copy of ``tsalign_tpu/parallel/sp_sweep.py``: one pair's primary
sweep with its query columns split over a mesh axis (``parallel/mesh.py``).
Each shard owns a contiguous block of columns, and the row recurrence runs
in lockstep over the shards; per row:

  1. each shard computes its block on its own device (plain torch, the
     counterpart of the JAX body under ``shard_map``);
  2. the diagonal and insertion-open shifts take the left neighbour's last
     column (`mesh.ppermute_right`; DEV_INF on shard 0);
  3. the within-row insertion chain is solved per block (`_chain_with_prefix`),
     and the blocks' aggregates (the chain at the block's end, the saturated
     extension sum) go to every shard (`mesh.all_gather`);
  4. each shard folds the carry of the blocks left of it into its block.

The columns are padded with DEV_INF to a multiple of the shard count (which
may exceed the width) and cut back at the end.  The result equals the
single-device sweep (``ops/primary.py::PrimarySweep.sweep``) bit for bit.
The sweep kernel cannot serve a shard: it computes a whole field in one
launch, while this design exchanges a column and a carry every row.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..ops.common import DEV_INF, I32, check_extension, full_inf
from ..ops.primary_sweep import GAP_DEL, GAP_INS, GAP_NONE
from .mesh import Mesh, all_gather, axis_size, ppermute_right, replicate


def _chain_with_prefix(cand, ext):
    """Local min-plus chain D[t] = min(cand[t], D[t-1] + ext[t]) (clamped at
    every add, from DEV_INF before the block) and the inclusive saturated
    prefix sum of ext, the two aggregates that splice the carry from the
    left into the block.  With ext >= 0 the chain has the closed form
    D[t] = min(S[t] + min_{k <= t} (cand[k] - S[k]), DEV_INF) for the exact
    prefix sums S (int64): ``ops/common.py::minplus_scan`` bit for bit (and
    so the JAX function's clamped combine wherever the candidates are >= 0,
    see ``ops/common.py``), in a handful of launches (a cumulative sum and a
    cumulative minimum) where a doubling scan takes a few a step."""
    S = torch.cumsum(ext.to(torch.int64), dim=-1)
    lo = torch.cummin(cand.to(torch.int64) - S, dim=-1).values
    return (S + lo).clamp_max(DEV_INF).to(I32), S.clamp_max(DEV_INF).to(I32)


def _sat(x):
    return torch.clamp_max(x, DEV_INF)


class _Shards:
    """The per-row exchanges of one sharded sweep over `mesh`."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.D = len(mesh.devices)

    def shift_right(self, stacks: List[torch.Tensor]) -> List[torch.Tensor]:
        """Shift each row of every shard's (k, Wd) stack right by one across
        the global row: the incoming column is the left neighbour's last
        column (DEV_INF on shard 0)."""
        recv = ppermute_right([s[:, -1:] for s in stacks], self.mesh)
        return [torch.cat([r, s[:, :-1]], dim=1) for r, s in zip(recv, stacks)]

    def chain(self, cands, ext_into):
        """The insertion chain over the global row: each block's local chain,
        the blocks' aggregates gathered, and the carry of the blocks left of
        each shard folded into it."""
        local = [_chain_with_prefix(c, e) for c, e in zip(cands, ext_into)]
        ce = all_gather([torch.stack([c[-1], e[-1]]) for c, e in local], self.mesh)
        out = [local[0][0]]  # shard 0's carry is DEV_INF
        for idx in range(1, self.D):
            c_loc, e_pref = local[idx]
            c_in = ce[idx][0, 0]
            for d in range(1, idx):
                c_in = torch.minimum(ce[idx][d, 0], _sat(c_in + ce[idx][d, 1]))
            out.append(torch.minimum(c_loc, _sat(c_in + e_pref)))
        return out


def _pad_split(x: torch.Tensor, padc: int, mesh: Mesh) -> List[torch.Tensor]:
    """Pad the last axis with `padc` DEV_INF columns and split it in
    contiguous equal blocks, one a shard, on the shards' devices."""
    x = torch.as_tensor(x).to(I32)
    if padc:
        x = torch.cat([x, torch.full(x.shape[:-1] + (padc,), DEV_INF, dtype=I32,
                                     device=x.device)], dim=-1)
    Wd = x.shape[-1] // len(mesh.devices)
    return [x[..., d * Wd : (d + 1) * Wd].to(dev).contiguous()
            for d, dev in enumerate(mesh.devices)]


def _gather_cols(outs: List[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    return torch.cat([o.to(mesh.devices[0]) for o in outs], dim=-1)


def sp_sweep_flankless(sweep, seeds, mesh: Mesh, axis: str = "sp") -> torch.Tensor:
    """Run a PrimarySweep's flankless sweep sequence-parallel over
    `mesh[axis]`.  `seeds`: (3, n_rows, Wq) int32 device costs (the F == 1
    slice of the engine's seed field; numpy or a tensor).  Returns M
    (3, n_rows, Wq), a tensor on the mesh's first device."""
    sub_rows, dd, io, ie = sweep.flankless_inputs()
    n_rows, Wq = sub_rows.shape
    D = axis_size(mesh, axis)
    padc = -(-Wq // D) * D - Wq
    check_extension("sp_sweep_flankless", torch.from_numpy(ie))
    sh = _Shards(mesh)

    sub_l = _pad_split(torch.from_numpy(sub_rows), padc, mesh)
    seeds_l = _pad_split(torch.as_tensor(seeds).permute(1, 0, 2), padc, mesh)
    io_l = _pad_split(torch.from_numpy(io), padc, mesh)
    ie_l = _pad_split(torch.from_numpy(ie), padc, mesh)
    dd_l = replicate(torch.from_numpy(dd).to(I32), mesh)
    ext_into = [x[0] for x in sh.shift_right([e[None] for e in ie_l])]  # cost INTO t

    Wd = sub_l[0].shape[-1]
    outs = [torch.empty((n_rows, 3, Wd), dtype=I32, device=dev) for dev in mesh.devices]
    prev = [full_inf((3, Wd), dev) for dev in mesh.devices]
    for r in range(n_rows):
        shifted = sh.shift_right([torch.stack([p.amin(dim=0), s[r]])
                                  for p, s in zip(prev, sub_l)])
        none_c, del_c, opens = [], [], []
        for d in range(D):
            p, s, x = prev[d], seeds_l[d][r], dd_l[d][r]
            n = torch.minimum(s[GAP_NONE], _sat(shifted[d][0] + shifted[d][1]))
            dl = torch.minimum(s[GAP_DEL], torch.minimum(
                _sat(torch.minimum(p[GAP_NONE], p[GAP_INS]) + x[0]), _sat(p[GAP_DEL] + x[1])))
            none_c.append(n)
            del_c.append(dl)
            opens.append(_sat(torch.minimum(n, dl) + io_l[d])[None])
        open_c = sh.shift_right(opens)
        ins_c = sh.chain([torch.minimum(s[r][GAP_INS], o[0]) for s, o in zip(seeds_l, open_c)],
                         ext_into)
        for d in range(D):
            torch.stack([none_c[d], ins_c[d], del_c[d]], out=outs[d][r])
            prev[d] = outs[d][r]
    return _gather_cols(outs, mesh).permute(1, 0, 2)[:, :, :Wq].contiguous()


def _climb_source(f: int, L: int, R: int, climb: bool):
    """(layer index of the climb edges' source, their table) into flank
    layer f, or (None, None) where the layer takes no climb edges."""
    fi = f + R
    if (-R < f < 0) or (f == 0 and R > 0):
        return fi - 1, 2
    if f > 0 and climb:
        return fi - 1, 1
    return None, None


def sp_sweep_flanked(sweep, seeds, mesh: Mesh, axis: str = "sp") -> np.ndarray:
    """Flank-layered primary sweep, query columns sharded over `mesh[axis]`.

    `sweep`: a PrimarySweep (any F); `seeds`: (F, 3, n_rows, Wq) int32 device
    costs (numpy or a tensor).  Returns M with the same layout, a numpy
    array.  Layer 0 takes the primary edges with the within-row chain (the
    carry across shards as in `sp_sweep_flankless`); flank layers receive
    climb edges only, whose one-step climb insertion shifts the finished
    layer below across the shards, in the layer order of the flanked
    kernel."""
    subs, dd, io, ie = sweep.flanked_inputs()
    F, L, R = sweep.F, sweep.L, sweep.R
    n_rows = sweep.n_r + 1
    Wq = sweep.n_q + 1
    D = axis_size(mesh, axis)
    padc = -(-Wq // D) * D - Wq
    check_extension("sp_sweep_flanked", torch.from_numpy(ie[0]))
    sh = _Shards(mesh)

    seeds_t = torch.as_tensor(seeds).reshape(F * 3, n_rows, Wq).permute(1, 0, 2)
    subs_l = _pad_split(torch.from_numpy(subs), padc, mesh)  # (3, n_rows, Wd)
    seeds_l = _pad_split(seeds_t, padc, mesh)  # (n_rows, 3F, Wd)
    io_l = _pad_split(torch.from_numpy(io), padc, mesh)  # (3, Wd)
    ie_l = _pad_split(torch.from_numpy(ie), padc, mesh)
    dd_l = replicate(torch.from_numpy(dd).to(I32), mesh)
    ext_into = [x[0] for x in sh.shift_right([e[0][None] for e in ie_l])]

    def diag_from(prev3, t, r):
        shifted = sh.shift_right([torch.stack([p.amin(dim=0), s[t, r]])
                                  for p, s in zip(prev3, subs_l)])
        return [_sat(x[0] + x[1]) for x in shifted]

    def del_from(prev3, t, r):
        return [torch.minimum(
            _sat(torch.minimum(p[GAP_NONE], p[GAP_INS]) + x[r, 2 * t]),
            _sat(p[GAP_DEL] + x[r, 2 * t + 1])) for p, x in zip(prev3, dd_l)]

    Wd = subs_l[0].shape[-1]
    outs = [torch.empty((n_rows, 3 * F, Wd), dtype=I32, device=dev) for dev in mesh.devices]
    carry = [full_inf((3 * F, Wd), dev) for dev in mesh.devices]
    for r in range(n_rows):
        rows = [None] * F  # each: [(none, ins, del) a shard]
        for f in range(-R, L + 1):
            fi = f + R
            climb_src, ct = _climb_source(f, L, R, sweep.climb)
            prev3 = [c[3 * fi : 3 * fi + 3] for c in carry]
            none_c = [s[r, 3 * fi + GAP_NONE] for s in seeds_l]
            ins_c = [s[r, 3 * fi + GAP_INS] for s in seeds_l]
            del_c = [s[r, 3 * fi + GAP_DEL] for s in seeds_l]
            if f == 0:
                none_c = [torch.minimum(a, b) for a, b in zip(none_c, diag_from(prev3, 0, r))]
                del_c = [torch.minimum(a, b) for a, b in zip(del_c, del_from(prev3, 0, r))]
            if climb_src is not None:
                prev_c = [c[3 * climb_src : 3 * climb_src + 3] for c in carry]
                none_c = [torch.minimum(a, b) for a, b in zip(none_c, diag_from(prev_c, ct, r))]
                del_c = [torch.minimum(a, b) for a, b in zip(del_c, del_from(prev_c, ct, r))]
                srcs = [torch.stack([_sat(torch.minimum(sn, sd) + io_l[d][ct]),
                                     _sat(si + ie_l[d][ct])])
                        for d, (sn, si, sd) in enumerate(rows[climb_src])]
                ins_c = [torch.minimum(a, torch.minimum(x[0], x[1]))
                         for a, x in zip(ins_c, sh.shift_right(srcs))]
            if f == 0:
                opens = [_sat(torch.minimum(n, dl) + io_l[d][0])[None]
                         for d, (n, dl) in enumerate(zip(none_c, del_c))]
                cands = [torch.minimum(a, o[0]) for a, o in zip(ins_c, sh.shift_right(opens))]
                ins_c = sh.chain(cands, ext_into)
            rows[fi] = list(zip(none_c, ins_c, del_c))
        for d in range(D):
            tri = [None] * (3 * F)
            for fi in range(F):
                n_, i_, d_ = rows[fi][d]
                tri[3 * fi + GAP_NONE], tri[3 * fi + GAP_INS], tri[3 * fi + GAP_DEL] = n_, i_, d_
            torch.stack(tri, out=outs[d][r])
            carry[d] = outs[d][r]
    M = _gather_cols(outs, mesh)[:, :, :Wq].cpu().numpy()
    return M.transpose(1, 0, 2).reshape(F, 3, n_rows, Wq)
