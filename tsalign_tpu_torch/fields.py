"""Host views of the per-round fields kept on the device, for the traceback.

Counterpart of ``tsalign_tpu/device_fields.py``.  The traceback reads
O(path length) scattered cells of the primary fields M_k (F, 3, n_r+1, n_q+1),
single cells of the reentry fields R_k, and the per-round entry layers.  The
fields stay on the device as torch tensors; a view copies a block of rows to
the host with a plain slice and ``.cpu()`` on first touch and answers from it:

  * ``view[:, :, i, j]``  -> (F, 3) int64 host array
  * ``view[fi, g, i, j]`` -> int64 host scalar
  * ``view.entry_cells()`` -> the round's entry layer (min over gap types of
    the top flank layer), as the round loop summarised it
  * 2-D views: ``view[i, j]`` -> int64 host scalar

Values come back in the host int64 cost domain (INF restored).
"""

from __future__ import annotations

import numpy as np

from .ops.common import from_device_costs

ROWS_PER_FETCH = 64


class _RowBlocks:
    """Row-block cache over the second-to-last axis of a device tensor."""

    def __init__(self, dev):
        self._dev = dev
        self.shape = tuple(dev.shape)
        self._blocks: dict = {}

    def _block(self, i: int):
        i0 = (i // ROWS_PER_FETCH) * ROWS_PER_FETCH
        blk = self._blocks.get(i0)
        if blk is None:
            rows = self._dev[..., i0 : i0 + ROWS_PER_FETCH, :]
            blk = from_device_costs(rows.cpu().numpy())
            self._blocks[i0] = blk
        return blk, i0


class FieldView4(_RowBlocks):
    """One round's primary field (F, 3, n_r+1, n_q+1)."""

    def __init__(self, dev, entry_cells: np.ndarray):
        super().__init__(dev)
        self._entry = entry_cells

    def __getitem__(self, idx):
        fi, g, i, j = idx
        blk, i0 = self._block(int(i))
        return blk[fi, g, int(i) - i0, int(j)]

    def entry_cells(self) -> np.ndarray:
        return self._entry


class FieldView2(_RowBlocks):
    """One round's reentry field (n_r+1, n_q+1)."""

    def __getitem__(self, idx):
        i, j = idx
        blk, i0 = self._block(int(i))
        return blk[int(i) - i0, int(j)]


def entry_cells_of(M) -> np.ndarray:
    """Entry layer of a primary field: works for host numpy fields and the
    lazy device views alike (the traceback's one whole-layer read)."""
    if hasattr(M, "entry_cells"):
        return M.entry_cells()
    return M[-1].min(axis=0)
