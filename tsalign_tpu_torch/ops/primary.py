"""Primary sweep host tables and sweep routing (F = L + R + 1 flank layers).

Counterpart of ``tsalign_tpu/ops/jax_primary.py::JaxPrimarySweep``: the same
per-row substitution / deletion tables and per-column insertion tables for
the primary, left-flank and right-flank cost tables
(``jax_primary.py:34-101``; the primary one alone when F == 1), laid out by
`flankless_inputs` and `flanked_inputs` exactly as the JAX class lays them
out, copied to a device in one piece by `_inputs_on`, and a `sweep` that
runs ``ops.sweep.sweep_flankless`` (F == 1) or ``ops.sweep.sweep_flanked``
(F > 1) on the seeds' device.  There is no size cap: the JAX class's
``_pallas_ok`` guards on-chip memory of another device.
"""

from __future__ import annotations

import copy
import math
from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..config import TemplateSwitchConfig
from ..costs import INF
from ..geometry import AlignmentRange
from .common import DEV_INF, device_key, to_device, to_device_costs
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


# The sweep's cost tables, in the order of its flanked layout.
_TABLES = ("primary_edit_costs", "left_flank_edit_costs", "right_flank_edit_costs")


class PrimarySweep:
    """Primary sweep for one (config, pair, range, climb).

    Its tables are built once, in the layout the sweep reads, in one int32
    buffer (`_pack`): each cost table clamped into the device algebra with
    an INF row and column for the poison char, then gathered by one row
    index a reference position and one column index a query position, where
    row 0, column n_q and every position outside the range take the poison
    index.  The sweep reads only the primary table when F == 1, so only
    that one is built then."""

    @tracing.spanned("engine.tables")
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
        ref = np.asarray(reference)
        qry = np.asarray(query)
        n_r, n_q = len(ref), len(qry)
        self.n_r, self.n_q = n_r, n_q
        rng = range_ or AlignmentRange.complete(n_r, n_q)
        # The rows' indices (row i + 1 reads reference position i), then the
        # columns' (column j reads query position j), in one array: row 0,
        # column n_q and every position outside the range index the poison
        # char, which prices as INF.
        pad_idx = config.alphabet.size
        idx = np.full(n_r + n_q + 2, pad_idx, dtype=np.intp)
        self._ri, self._qi = idx[: n_r + 1], idx[n_r + 1 :]
        r0, r1 = rng.reference_offset, min(rng.reference_limit, n_r)
        q0, q1 = rng.query_offset, min(rng.query_limit, n_q)
        self._ri[1 + r0 : 1 + r1] = ref[r0:r1]
        self._qi[q0:q1] = qry[q0:q1]
        np.clip(idx, 0, pad_idx, out=idx)
        self._buf, self._shapes = self._pack(_TABLES[:1] if self.F == 1 else _TABLES)
        self._dev_inputs = {}

    def _pack(self, names):
        """One contiguous int32 buffer holding, for the named tables (k of
        them), subs (k, n_rows, Wq), ddrows (n_rows, 2k: del open and
        extend a table), io (k, Wq) and ie (k, Wq) in this order; and their
        shapes, the table axis dropped when k == 1."""
        k = len(names)
        n_rows, Wq = self.n_r + 1, self.n_q + 1
        A1 = self.config.alphabet.size + 1
        subs_n, dd_n, ins_n = k * n_rows * Wq, n_rows * 2 * k, k * Wq
        buf = np.empty(subs_n + dd_n + 2 * ins_n, dtype=np.int32)
        subs = buf[:subs_n].reshape(k, n_rows, Wq)
        gaps = np.full((k, 2, A1), DEV_INF, dtype=np.int32)  # open, extend
        for t, name in enumerate(names):
            table = getattr(self.config, name)
            sub = np.full((A1, A1), DEV_INF, dtype=np.int32)
            sub[:-1, :-1] = to_device_costs(table.substitution)
            gaps[t, 0, :-1] = to_device_costs(table.gap_open)
            gaps[t, 1, :-1] = to_device_costs(table.gap_extend)
            # The indices lie in 0..A by construction; "clip" lets take
            # write straight into `out`, where "raise" goes through a buffer.
            np.take(sub[:, self._qi], self._ri, axis=0, out=subs[t], mode="clip")
        dd = buf[subs_n : subs_n + dd_n].reshape(n_rows, 2 * k)
        np.take(gaps.reshape(2 * k, A1).T, self._ri, axis=0, out=dd, mode="clip")
        ins = buf[subs_n + dd_n :].reshape(2, k, Wq)  # io, then ie
        np.take(gaps.transpose(1, 0, 2), self._qi, axis=2, out=ins, mode="clip")
        one = () if k == 1 else (k,)
        shapes = (one + (n_rows, Wq), (n_rows, 2 * k), one + (Wq,), one + (Wq,))
        return buf, shapes

    @staticmethod
    def _views(flat, shapes):
        """The arrays of `shapes`, in order, as views of the flat buffer
        `flat` (numpy, or torch: one split, then a reshape of each part
        that has more than one axis)."""
        sizes = [math.prod(shape) for shape in shapes]
        if isinstance(flat, torch.Tensor):
            parts = flat.split(sizes)
        else:
            parts = np.split(flat, np.cumsum(sizes[:-1]))
        return tuple(p if len(s) == 1 else p.reshape(s) for p, s in zip(parts, shapes))

    def flankless_inputs(self):
        """(sub_rows (n_rows, Wq), ddrows (n_rows, 2), io (Wq,), ie (Wq,))
        int32 numpy of the primary table, laid out as
        ``JaxPrimarySweep.flankless_inputs`` (views of the sweep's own
        buffer when F == 1: read, do not write)."""
        arrays = self._views(self._buf, self._shapes)
        if self.F == 1:
            return arrays
        subs, dd, io, ie = arrays
        return subs[0], np.ascontiguousarray(dd[:, :2]), io[0], ie[0]

    def flanked_inputs(self):
        """(subs (3, n_rows, Wq), ddrows (n_rows, 6), io (3, Wq), ie (3, Wq))
        int32 numpy for the tables (primary, left, right), laid out as
        ``JaxPrimarySweep.flanked_inputs``: row 0 and column n_q all-INF,
        ddrows holds del open/extend per table (views of the sweep's own
        buffer when F > 1: read, do not write)."""
        if self.F > 1:
            return self._views(self._buf, self._shapes)
        return self._views(*self._pack(_TABLES))

    def _inputs_on(self, device):
        """The sweep's tables on `device`: one copy of the buffer, and views
        of it in the layout of `flankless_inputs` (F == 1) or
        `flanked_inputs`."""
        key = device_key(device)
        if key not in self._dev_inputs:
            with tracing.span("engine.tables"):
                flat = to_device(self._buf, device)
                self._dev_inputs[key] = self._views(flat, self._shapes)
        return self._dev_inputs[key]

    @tracing.spanned("engine.sweep")
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
