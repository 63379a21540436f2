"""Primary sweep host tables and driver (flankless, F = 1).

Counterpart of ``tsalign_tpu/ops/jax_primary.py::JaxPrimarySweep``: the same
per-row substitution / deletion tables and per-column insertion tables
(``jax_primary.py:34-101``, primary table only), laid out by
`flankless_inputs` exactly as ``JaxPrimarySweep.flankless_inputs``, and a
`sweep` that runs ``ops.sweep.sweep_flankless`` on the seeds' device.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from tsalign_tpu.config import TemplateSwitchConfig
from tsalign_tpu.costs import INF
from tsalign_tpu.geometry import AlignmentRange

from .common import DEV_INF, to_device_costs
from .sweep import sweep_flankless


def pad_table_for_poison(table):
    """Copy of a GapAffineCostTable with one extra INF row/column/entry so
    the poison padding char (index == alphabet size) prices as INF
    (the port's copy of ``jax_primary._pad_table_for_poison``)."""
    t = copy.copy(table)
    t.substitution = np.pad(table.substitution, ((0, 1), (0, 1)), constant_values=INF)
    t.gap_open = np.pad(table.gap_open, (0, 1), constant_values=INF)
    t.gap_extend = np.pad(table.gap_extend, (0, 1), constant_values=INF)
    return t


class PrimarySweep:
    """Flankless primary sweep for one (config, pair, range)."""

    def __init__(
        self,
        config: TemplateSwitchConfig,
        reference: np.ndarray,
        query: np.ndarray,
        range_: Optional[AlignmentRange] = None,
    ):
        self.config = config
        self.L = config.left_flank_length
        self.R = config.right_flank_length
        self.F = self.L + self.R + 1
        if self.F != 1:
            raise NotImplementedError(
                "the flanked sweep (F > 1) is not ported yet "
                "(ROADMAP queue 1 item 6, queue 2 item 3)"
            )
        ref = np.asarray(reference, dtype=np.int64)
        qry = np.asarray(query, dtype=np.int64)
        n_r, n_q = len(ref), len(qry)
        self.n_r, self.n_q = n_r, n_q
        rng = range_ or AlignmentRange.complete(n_r, n_q)
        ref_ok = np.zeros(n_r + 1, dtype=bool)
        qry_ok = np.zeros(n_q + 1, dtype=bool)
        ref_ok[rng.reference_offset : rng.reference_limit] = True
        qry_ok[rng.query_offset : rng.query_limit] = True
        pad_idx = config.alphabet.size
        ref = np.clip(ref, 0, pad_idx)
        qry = np.clip(qry, 0, pad_idx)

        table = pad_table_for_poison(config.primary_edit_costs)
        subrow = np.full((n_r + 1, n_q), INF, dtype=np.int64)
        delopen = np.full(n_r + 1, INF, dtype=np.int64)
        delext = np.full(n_r + 1, INF, dtype=np.int64)
        if n_r and n_q:
            sub = np.where(
                qry_ok[None, :n_q], table.substitution[ref[:, None], qry[None, :]], INF
            )
            subrow[1:] = np.where(ref_ok[:n_r, None], sub, INF)
        if n_r:
            delopen[1:] = np.where(ref_ok[:n_r], table.gap_open[ref], INF)
            delext[1:] = np.where(ref_ok[:n_r], table.gap_extend[ref], INF)
        insopen = np.where(qry_ok[:n_q], table.gap_open[qry], INF)
        insext = np.where(qry_ok[:n_q], table.gap_extend[qry], INF)
        self._rows = tuple(to_device_costs(x) for x in (subrow, delopen, delext))
        self._ins = (to_device_costs(insopen), to_device_costs(insext))
        self._dev_inputs = {}

    def flankless_inputs(self):
        """(sub_rows (n_rows, Wq), ddrows (n_rows, 2), io (Wq,), ie (Wq,))
        int32 numpy, laid out as ``JaxPrimarySweep.flankless_inputs``."""
        sub, do, de = self._rows
        n_rows, Wq = self.n_r + 1, self.n_q + 1
        sub_rows = np.full((n_rows, Wq), DEV_INF, np.int32)
        sub_rows[:, : self.n_q] = sub
        dd = np.stack([do, de], axis=1).astype(np.int32)
        io = np.full(Wq, DEV_INF, np.int32)
        ie = np.full(Wq, DEV_INF, np.int32)
        io[: self.n_q] = self._ins[0]
        ie[: self.n_q] = self._ins[1]
        return sub_rows, dd, io, ie

    def _inputs_on(self, device):
        key = str(device)
        if key not in self._dev_inputs:
            self._dev_inputs[key] = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in self.flankless_inputs()
            )
        return self._dev_inputs[key]

    def sweep(self, seeds: torch.Tensor) -> torch.Tensor:
        """seeds (1, 3, n_r+1, n_q+1) int32 -> M (1, 3, n_r+1, n_q+1) int32,
        on the seeds' device."""
        sub_rows, dd, io, ie = self._inputs_on(seeds.device)
        M = sweep_flankless(
            sub_rows, dd, seeds[0].permute(1, 0, 2).contiguous(), io, ie
        )
        return M.permute(1, 0, 2).contiguous()[None]
