"""Carry the engine's host tables across to torch tensors.

The system has no weights; its state is the per-kind and per-sweep tables.
`tables_from_numpy` turns a dict of numpy arrays (the port's own
``KindModule.host_tables()``, or ``np.asarray`` of each entry of the JAX
package's ``JaxKindModule._fixed`` or ``JaxPrimarySweep.flankless_inputs()``)
into int32 tensors on a device, so that tests can feed the JAX functions and
the port identical tables.
"""

from __future__ import annotations

import numpy as np
import torch


def tables_from_numpy(d: dict, device) -> dict:
    """{name: numpy array} -> {name: contiguous int32 tensor on device}."""
    out = {}
    for name, arr in d.items():
        a = np.ascontiguousarray(np.asarray(arr))
        if a.dtype != np.int32:
            if a.size and (a.min() < np.iinfo(np.int32).min or a.max() > np.iinfo(np.int32).max):
                raise ValueError(f"table {name!r} does not fit int32")
            a = a.astype(np.int32)
        out[name] = torch.from_numpy(a).to(device)
    return out
