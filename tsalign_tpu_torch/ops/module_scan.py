"""The cross-kind module scan: the CUDA kernel's wrapper.

`module_scan` takes the inputs of the Pallas kernel
``tsalign_tpu/ops/pallas_module.py::module_scan_pallas``: seedT (NB, C, W),
lut (A, C, W), sdo/sde (C, W), pchar/pmask/io/ie (L, NB), all int32, and
returns B (L+1, NB, C).  For tensors on the CPU it runs the plain version
``ops.modules.module_scan_torch``; for tensors on a CUDA device it launches
``csrc/module_scan.cu``.
"""

from __future__ import annotations

import torch

from .. import _build
from .common import I32, check_tensor
from .modules import module_scan_torch

MAX_W = 32 * 64  # the widest instantiation of the kernel


def module_scan(seedT, lut, sdo, sde, pchar, pmask, io, ie, *, fwd: bool,
                allow_sdel: bool):
    """B (L+1, NB, C): per-level exit minima of each (entry row, column)."""
    if seedT.dim() != 3 or lut.dim() != 3 or pchar.dim() != 2:
        raise ValueError("module_scan takes seedT (NB, C, W), lut (A, C, W), pchar (L, NB)")
    NB, C, W = seedT.shape
    A = lut.shape[0]
    L = pchar.shape[0]
    dev = seedT.device
    check_tensor("seedT", seedT, (NB, C, W), dev)
    check_tensor("lut", lut, (A, C, W), dev)
    for name, t in (("sdo", sdo), ("sde", sde)):
        check_tensor(name, t, (C, W), dev)
    for name, t in (("pchar", pchar), ("pmask", pmask), ("io", io), ("ie", ie)):
        check_tensor(name, t, (L, NB), dev)
    if dev.type == "cpu":
        return module_scan_torch(seedT, lut, sdo, sde, pchar, pmask, io, ie,
                                 fwd=fwd, allow_sdel=allow_sdel)
    if dev.type != "cuda":
        raise ValueError(f"module_scan runs on cpu or cuda, not {dev}")
    if W > MAX_W:
        raise ValueError(f"module_scan kernel takes W <= {MAX_W}, got {W}")
    lib = _build.library()
    out = torch.empty((L + 1, NB, C), dtype=I32, device=dev)
    if NB and C:
        code = lib.tsa_module_scan(
            seedT.data_ptr(), lut.data_ptr(), sdo.data_ptr(), sde.data_ptr(),
            pchar.data_ptr(), pmask.data_ptr(), io.data_ptr(), ie.data_ptr(),
            out.data_ptr(), NB, C, W, L, A, int(fwd), int(allow_sdel),
            _build.stream_ptr(dev),
        )
        _build.check(code, "module_scan")
        _build.launches["module_scan"] += 1
    return out
