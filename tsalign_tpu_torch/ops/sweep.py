"""The flankless primary sweep: plain torch version and the CUDA kernel's wrapper.

`sweep_flankless_torch` is the plain version of the JAX package's ``_sweep_jit``
at F = 1 (``ops/jax_primary.py``), written row by row like the Pallas kernel
``ops/pallas_sweep.py::_sweep_kernel``.  `sweep_flankless` runs it for tensors
on the CPU and launches ``csrc/sweep_flankless.cu`` for tensors on a CUDA
device.  Inputs and output use the Pallas layout: sub_rows (n_rows, Wq),
ddrows (n_rows, 2), seeds (n_rows, 3, Wq), io/ie (Wq,) -> M (n_rows, 3, Wq),
all int32.
"""

from __future__ import annotations

import torch

from tsalign_tpu.ops.primary_sweep import GAP_DEL, GAP_INS, GAP_NONE

from .. import _build
from .common import (DEV_INF, I32, check_extension, check_tensor, minplus_scan, sat_add,
                     shift_last)


def sweep_flankless_torch(sub_rows, ddrows, seeds, io, ie):
    """Plain torch flankless sweep (any device)."""
    n_rows, Wq = sub_rows.shape
    out = torch.empty((n_rows, 3, Wq), dtype=I32, device=sub_rows.device)
    prev = torch.full((3, Wq), DEV_INF, dtype=I32, device=sub_rows.device)
    check_extension("sweep_flankless_torch", ie)
    ext_into = shift_last(ie, 1, True)
    for r in range(n_rows):
        d_open, d_ext = ddrows[r, 0], ddrows[r, 1]
        any_prev = prev.amin(dim=0)
        diag = torch.clamp_max(
            shift_last(any_prev, 1, True) + shift_last(sub_rows[r], 1, True),
            DEV_INF,
        )
        none_c = torch.minimum(seeds[r, GAP_NONE], diag)
        del_new = torch.minimum(
            sat_add(torch.minimum(prev[GAP_NONE], prev[GAP_INS]), d_open),
            sat_add(prev[GAP_DEL], d_ext),
        )
        del_c = torch.minimum(seeds[r, GAP_DEL], del_new)
        open_c = shift_last(sat_add(torch.minimum(none_c, del_c), io), 1, True)
        cand = torch.minimum(seeds[r, GAP_INS], open_c)
        ins_c = minplus_scan(cand, ext_into)
        out[r, GAP_NONE] = none_c
        out[r, GAP_INS] = ins_c
        out[r, GAP_DEL] = del_c
        prev = out[r]
    return out


def sweep_flankless(sub_rows, ddrows, seeds, io, ie):
    """Flankless sweep: the plain version on the CPU, the kernel on CUDA."""
    if sub_rows.dim() != 2:
        raise ValueError("sub_rows must be (n_rows, Wq)")
    n_rows, Wq = sub_rows.shape
    dev = sub_rows.device
    check_tensor("sub_rows", sub_rows, (n_rows, Wq), dev)
    check_tensor("ddrows", ddrows, (n_rows, 2), dev)
    check_tensor("seeds", seeds, (n_rows, 3, Wq), dev)
    check_tensor("io", io, (Wq,), dev)
    check_tensor("ie", ie, (Wq,), dev)
    if dev.type == "cpu":
        return sweep_flankless_torch(sub_rows, ddrows, seeds, io, ie)
    if dev.type != "cuda":
        raise ValueError(f"sweep_flankless runs on cpu or cuda, not {dev}")
    lib = _build.library()
    out = torch.empty((n_rows, 3, Wq), dtype=I32, device=dev)
    if n_rows and Wq:
        code = lib.tsa_sweep_flankless(
            sub_rows.data_ptr(), ddrows.data_ptr(), seeds.data_ptr(),
            io.data_ptr(), ie.data_ptr(), out.data_ptr(), n_rows, Wq,
            _build.stream_ptr(dev),
        )
        _build.check(code, "sweep_flankless")
        _build.launches["sweep_flankless"] += 1
    return out
