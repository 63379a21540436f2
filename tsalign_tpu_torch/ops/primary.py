"""Primary sweep host tables and sweep routing (F = L + R + 1 flank layers).

Counterpart of ``tsalign_tpu/ops/jax_primary.py::JaxPrimarySweep``: the same
per-row substitution / deletion tables and per-column insertion tables for
the primary, left-flank and right-flank cost tables
(``jax_primary.py:34-101``), laid out by `flankless_inputs` and
`flanked_inputs` exactly as the JAX class lays them out, and a `sweep` that
runs ``ops.sweep.sweep_flankless`` (F == 1) or ``ops.sweep.sweep_flanked``
(F > 1) on the seeds' device.  There is no size cap: the JAX class's
``_pallas_ok`` guards on-chip memory of another device.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from ..config import TemplateSwitchConfig
from ..costs import INF
from ..geometry import AlignmentRange
from .common import DEV_INF, device_key, to_device_costs
from .sweep import sweep_flanked, sweep_flankless


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
    """Primary sweep for one (config, pair, range, climb)."""

    def __init__(
        self,
        config: TemplateSwitchConfig,
        reference: np.ndarray,
        query: np.ndarray,
        range_: Optional[AlignmentRange] = None,
        allow_flank_climb: bool = True,
    ):
        self.config = config
        self.L = config.left_flank_length
        self.R = config.right_flank_length
        self.F = self.L + self.R + 1
        self.climb = allow_flank_climb
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

        self._rows = {}
        self._ins = {}
        for name, table in (
            ("primary", config.primary_edit_costs),
            ("left", config.left_flank_edit_costs),
            ("right", config.right_flank_edit_costs),
        ):
            table = pad_table_for_poison(table)
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
            self._rows[name] = tuple(to_device_costs(x) for x in (subrow, delopen, delext))
            self._ins[name] = (to_device_costs(insopen), to_device_costs(insext))
        self._dev_inputs = {}

    def flankless_inputs(self):
        """(sub_rows (n_rows, Wq), ddrows (n_rows, 2), io (Wq,), ie (Wq,))
        int32 numpy, laid out as ``JaxPrimarySweep.flankless_inputs``."""
        sub, do, de = self._rows["primary"]
        n_rows, Wq = self.n_r + 1, self.n_q + 1
        sub_rows = np.full((n_rows, Wq), DEV_INF, np.int32)
        sub_rows[:, : self.n_q] = sub
        dd = np.stack([do, de], axis=1).astype(np.int32)
        io = np.full(Wq, DEV_INF, np.int32)
        ie = np.full(Wq, DEV_INF, np.int32)
        io[: self.n_q] = self._ins["primary"][0]
        ie[: self.n_q] = self._ins["primary"][1]
        return sub_rows, dd, io, ie

    def flanked_inputs(self):
        """(subs (3, n_rows, Wq), ddrows (n_rows, 6), io (3, Wq), ie (3, Wq))
        int32 numpy for the tables (primary, left, right), laid out as
        ``JaxPrimarySweep.flanked_inputs``: row 0 and column n_q all-INF,
        ddrows holds del open/extend per table."""
        n_rows, Wq = self.n_r + 1, self.n_q + 1
        subs = np.full((3, n_rows, Wq), DEV_INF, np.int32)
        dd = np.full((n_rows, 6), DEV_INF, np.int32)
        io = np.full((3, Wq), DEV_INF, np.int32)
        ie = np.full((3, Wq), DEV_INF, np.int32)
        for t, name in enumerate(("primary", "left", "right")):
            sub, do, de = self._rows[name]
            subs[t, :, : self.n_q] = sub
            dd[:, 2 * t] = do
            dd[:, 2 * t + 1] = de
            io[t, : self.n_q] = self._ins[name][0]
            ie[t, : self.n_q] = self._ins[name][1]
        return subs, dd, io, ie

    def _inputs_on(self, device):
        key = device_key(device)
        if key not in self._dev_inputs:
            arrays = self.flankless_inputs() if self.F == 1 else self.flanked_inputs()
            self._dev_inputs[key] = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays
            )
        return self._dev_inputs[key]

    def sweep(self, seeds: torch.Tensor) -> torch.Tensor:
        """seeds (F, 3, n_r+1, n_q+1) int32 -> M (F, 3, n_r+1, n_q+1) int32,
        on the seeds' device."""
        n_rows, Wq = self.n_r + 1, self.n_q + 1
        if tuple(seeds.shape) != (self.F, 3, n_rows, Wq):
            raise ValueError(
                f"seeds must have shape {(self.F, 3, n_rows, Wq)}, got {tuple(seeds.shape)}"
            )
        tables = self._inputs_on(seeds.device)
        # Both sweeps read and write this plane-major layout in place:
        # their (n_rows, 3F, Wq) argument is a view, and so is M.
        seeds_r = seeds.contiguous().view(self.F * 3, n_rows, Wq).permute(1, 0, 2)
        if self.F == 1:
            sub_rows, dd, io, ie = tables
            M = sweep_flankless(sub_rows, dd, seeds_r, io, ie)
            return M.permute(1, 0, 2).reshape(1, 3, n_rows, Wq)
        subs, dd, io, ie = tables
        M = sweep_flanked(subs, dd, seeds_r, io, ie, L=self.L, R=self.R, climb=self.climb)
        return M.permute(1, 0, 2).reshape(self.F, 3, n_rows, Wq)
