"""Sequence-parallel TSM module sweeps (the reentry step).

The port's copy of ``tsalign_tpu/parallel/sp_reentry.py``.  A kind's module
launches are independent along the entry axis: every chunk's scan stands
alone, and the per-chunk slabs only meet in the min-fold into the reentry
field.  So the chunk offsets of a kind are split in contiguous blocks over a
mesh axis (``parallel/mesh.py``): each shard runs its chunks through the
single-device chunked route ``ops/modules.py::kind_all_chunks`` on its device
(the module-scan kernel on a card, its diagonal mode for same-sequence kinds,
whose module field is cached per card, so shards on one card scan it once),
into a full-width slab at global offsets, and one `mesh.pmin` combines the
slabs.  The entry field and the kind's tables are replicated.  The result
equals the unsharded chunked route (``engine.TorchAligner._reentry``) bit for
bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.common import DEV_INF, full_inf
from ..ops.modules import kind_all_chunks
from .mesh import Mesh, axis_size, pmin


def sp_reentry_kind(km, A_mod: np.ndarray, mesh: Mesh, axis: str = "sp") -> np.ndarray:
    """One kind's reentry slab, module chunks sharded over `mesh[axis]`.

    A_mod: (n_p+1, >=n_e) int32 device-cost entry field in the kind's module
    orientation.  Returns the padded reentry field (n_p+1, width) as a host
    array (the layout of the unsharded chunked route)."""
    spec = km.spec
    C = km.chunk
    n_e = spec.n_anti + 1
    D = axis_size(mesh, axis)
    A_mod = np.asarray(A_mod, dtype=np.int32)
    if A_mod.shape[1] < C:
        A_mod = np.pad(A_mod, ((0, 0), (0, C - A_mod.shape[1])), constant_values=DEV_INF)

    # Global chunk offsets, padded with -1 (a skipped chunk) to a multiple of
    # D; shard d takes the contiguous block d.
    bases = [min(e0, n_e - C) if n_e >= C else 0 for e0 in range(0, n_e, C)]
    per_dev = -(-len(bases) // D)
    bases += [-1] * (D * per_dev - len(bases))
    e_bases = np.asarray(bases, np.int32)

    PAD = max(0, -km.s_lo)
    width = PAD + n_e + max(0, C - 1 + km.s_hi)
    A_host = torch.from_numpy(np.ascontiguousarray(A_mod))
    slabs = []
    for d, dev in enumerate(mesh.devices):
        eb = e_bases[None, d * per_dev : (d + 1) * per_dev]
        (slab,) = kind_all_chunks([km], A_host.to(dev)[None], eb, PAD, width)
        # a shard with no live chunk contributes nothing
        slabs.append(full_inf((spec.n_p + 1, width), dev) if slab is None else slab)
    return pmin(slabs, mesh)[0].cpu().numpy()


def sp_reentry(engine, A_cells: np.ndarray, kinds, mesh: Mesh, axis: str = "sp") -> np.ndarray:
    """All-kinds sharded reentry field (device costs, a host array), the
    sequence-parallel counterpart of ``TorchAligner._reentry``'s chunked
    route."""
    R_cells = np.full((engine.n_r + 1, engine.n_q + 1), DEV_INF, np.int32)
    for km in kinds:
        spec = km.spec
        A_mod = A_cells if spec.pk == 0 else A_cells.T
        Rk_pad = sp_reentry_kind(km, A_mod, mesh, axis=axis)
        PAD = max(0, -km.s_lo)
        Rk = Rk_pad[:, PAD : PAD + spec.n_anti + 1].copy()
        Rk[:, spec.n_anti] = DEV_INF  # strict reentry: j2 < n_anti
        if spec.pk == 1:
            Rk = Rk.T
        np.minimum(R_cells, Rk, out=R_cells)
    return R_cells
