"""Batched pair-level data parallelism over a device mesh.

The port's copy of ``tsalign_tpu/parallel/batch.py``: the batched
gap-affine core (the --no-ts cost of many pairs at once), with the pair axis
split over a mesh's "data" axis by `BatchedGapAffine.sharded_step`.

  * `encode_batch`: a copy (a (B, L) int32 batch padded with -1);
  * `batched_gap_affine`: the plain torch copy of ``_batched_gap_affine``
    (row by row, ``ops.common.minplus_scan`` for the insertion chains); the
    CPU path and the reference of the kernel route;
  * `sweep_gap_affine`: the kernel route, the same recurrence as the
    flankless primary sweep from one root seed at (0, 0) in ``GAP_NONE``:
    the batch's tables laid out as ``ops/primary.py::PrimarySweep.flankless_inputs``
    lays out one pair's (-1 characters price as DEV_INF rows and columns),
    one launch of ``ops/sweep.py::sweep_flankless`` with its pair axis, and
    each pair's cost, the minimum over the three planes, read at its own
    (len_r, len_q) corner;
  * `BatchedGapAffine(config, device=...)`: `costs` runs the kernel route
    on a CUDA device and the plain copy on the CPU; `sharded_step(mesh, ...)`
    runs `costs`' route a shard at a time on the shard's device, gathers the
    costs in shard order and takes their float32 mean (``parallel/mesh.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import TemplateSwitchConfig
from ..ops.common import (DEV_INF, check_extension, device_key, full_inf, minplus_scan,
                          sat_add, to_device, to_device_costs, to_host)
from ..ops.primary_sweep import GAP_NONE
from ..ops.sweep import sweep_flankless
from .mesh import Mesh, all_gather, pmean, shard_blocks


def encode_batch(alphabet, sequences, pad_to: Optional[int] = None) -> np.ndarray:
    """Encode a list of strings into a (B, L) int32 batch padded with -1."""
    arrs = [alphabet.encode(s.upper()) for s in sequences]
    L = pad_to or max((len(a) for a in arrs), default=0)
    out = np.full((len(arrs), L), -1, dtype=np.int32)
    for k, a in enumerate(arrs):
        out[k, : len(a)] = a
    return out


def _valid_codes(seqs, alpha_size: int):
    valid = seqs >= 0
    return valid, seqs.clamp(0, alpha_size - 1).long()


def _corner(planes, len_q):
    """min over the planes of each pair's value at column len_q: planes
    (k, B, W) -> (B,)."""
    return torch.stack([p.gather(1, len_q[:, None])[:, 0] for p in planes]).amin(dim=0)


def batched_gap_affine(alpha_size: int, sub, go, ge, refs, qrys):
    """Batched gap-affine global alignment costs (plain torch, any device).

    sub: (A, A) int32 device costs; go/ge: (A,) open/extend vectors;
    refs: (B, NR) int32, -1 padded; qrys: (B, NQ) int32, -1 padded.
    Returns (B,) int32 costs (value at each pair's (len_r, len_q) corner)."""
    B, NR = refs.shape
    NQ = qrys.shape[1]
    dev = refs.device
    q_valid, qc = _valid_codes(qrys, alpha_size)
    ins_open = torch.where(q_valid, go[qc], DEV_INF)  # (B, NQ)
    ins_ext = torch.where(q_valid, ge[qc], DEV_INF)
    check_extension("batched_gap_affine", ins_ext)
    pad1 = full_inf((B, 1), dev)
    ext_into = torch.cat([pad1, ins_ext], dim=1)

    def row_chain(none_c, del_c):
        open_src = torch.minimum(none_c, del_c)
        return minplus_scan(torch.cat([pad1, sat_add(open_src[:, :-1], ins_open)], dim=1),
                            ext_into)

    none_p = full_inf((B, NQ + 1), dev)
    none_p[:, 0] = 0
    del_p = full_inf((B, NQ + 1), dev)
    ins_p = row_chain(none_p, del_p)

    r_valid, rc = _valid_codes(refs, alpha_size)
    subrow_all = torch.where(r_valid[:, :, None] & q_valid[:, None, :],
                             sub[rc[:, :, None], qc[:, None, :]], DEV_INF)  # (B, NR, NQ)
    del_open_all = torch.where(r_valid, go[rc], DEV_INF)  # (B, NR)
    del_ext_all = torch.where(r_valid, ge[rc], DEV_INF)
    # Each pair reads its cost at its own (len_r, len_q) corner: the corner
    # values of every row at column len_q, then row len_r of them.
    len_q = q_valid.sum(dim=1)
    len_r = r_valid.sum(dim=1)
    corners = [_corner((none_p, ins_p, del_p), len_q)]
    for i in range(NR):
        any_p = torch.minimum(torch.minimum(none_p, ins_p), del_p)
        none_c = torch.cat([pad1, sat_add(any_p[:, :-1], subrow_all[:, i])], dim=1)
        open_src = torch.minimum(none_p, ins_p)
        del_c = torch.minimum(sat_add(open_src, del_open_all[:, i, None]),
                              sat_add(del_p, del_ext_all[:, i, None]))
        ins_c = row_chain(none_c, del_c)
        none_p, ins_p, del_p = none_c, ins_c, del_c
        corners.append(_corner((none_c, ins_c, del_c), len_q))
    corners = torch.stack(corners)  # (NR+1, B)
    return corners.gather(0, len_r[None, :])[0]


def sweep_gap_affine(alpha_size: int, sub, go, ge, refs, qrys):
    """`batched_gap_affine` through the flankless primary sweep with its pair
    axis: the batch's flankless sweep tables (a pair's row 0 and column NQ,
    and every -1 character's row or column, DEV_INF), the root seed 0 at
    (0, GAP_NONE, 0), one call of ``sweep_flankless`` (one kernel launch on a
    CUDA device, its plain version on the CPU), then the minimum over the
    three planes at each pair's (len_r, len_q)."""
    B, NR = refs.shape
    NQ = qrys.shape[1]
    dev = refs.device
    r_valid, rc = _valid_codes(refs, alpha_size)
    q_valid, qc = _valid_codes(qrys, alpha_size)
    sub_rows = full_inf((B, NR + 1, NQ + 1), dev)
    sub_rows[:, 1:, :NQ] = torch.where(r_valid[:, :, None] & q_valid[:, None, :],
                                       sub[rc[:, :, None], qc[:, None, :]], DEV_INF)
    dd = full_inf((B, NR + 1, 2), dev)
    dd[:, 1:, 0] = torch.where(r_valid, go[rc], DEV_INF)
    dd[:, 1:, 1] = torch.where(r_valid, ge[rc], DEV_INF)
    io = full_inf((B, NQ + 1), dev)
    ie = full_inf((B, NQ + 1), dev)
    io[:, :NQ] = torch.where(q_valid, go[qc], DEV_INF)
    ie[:, :NQ] = torch.where(q_valid, ge[qc], DEV_INF)
    seeds = full_inf((B, NR + 1, 3, NQ + 1), dev)
    seeds[:, 0, GAP_NONE, 0] = 0
    M = sweep_flankless(sub_rows, dd, seeds, io, ie)
    idx = torch.arange(B, device=dev)
    return M[idx, r_valid.sum(dim=1), :, q_valid.sum(dim=1)].amin(dim=-1)


class BatchedGapAffine:
    """Host wrapper: config -> device tables; sharded batched execution."""

    def __init__(self, config: TemplateSwitchConfig, *, device):
        self.config = config
        self.device = torch.device(device)
        t = config.primary_edit_costs
        self._host = tuple(to_device_costs(x) for x in (t.substitution, t.gap_open, t.gap_extend))
        self._tables = {}
        self.A = config.alphabet.size

    def tables(self, device):
        """(sub, go, ge) int32 tensors on `device`."""
        key = device_key(device)
        if key not in self._tables:
            self._tables[key] = tuple(to_device(x, device) for x in self._host)
        return self._tables[key]

    def _costs_on(self, device, refs, qrys) -> torch.Tensor:
        device = torch.device(device)
        r = to_device(np.asarray(refs, dtype=np.int32), device)
        q = to_device(np.asarray(qrys, dtype=np.int32), device)
        route = batched_gap_affine if device.type == "cpu" else sweep_gap_affine
        return route(self.A, *self.tables(device), r, q)

    def costs(self, refs: np.ndarray, qrys: np.ndarray) -> np.ndarray:
        return to_host(self._costs_on(self.device, refs, qrys))

    def sharded_step(self, mesh: Mesh, refs, qrys):
        """One data-parallel step over `mesh` (axis "data"): per-pair costs
        gathered in order and the batch-mean cost, both on the mesh's first
        device."""
        refs, qrys = np.asarray(refs), np.asarray(qrys)
        parts = [self._costs_on(dev, refs[sl], qrys[sl])
                 for sl, dev in shard_blocks(mesh, len(refs), "data")]
        costs = all_gather(parts, mesh)[0].reshape(-1)
        return costs, pmean(parts, mesh)[0]
