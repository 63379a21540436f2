"""The cross-kind module scan: the CUDA kernel's wrapper.

`module_scan` takes the inputs of the Pallas kernel
``tsalign_tpu/ops/pallas_module.py::module_scan_pallas``: seedT (NB, C, W),
lut (A, C, W), sdo/sde (C, W), pchar/pmask/io/ie (L, NB), all int32, and
returns B (L+1, NB, C).  For tensors on the CPU it runs the plain version
``ops.modules.module_scan_torch``; for tensors on a CUDA device it launches
``csrc/module_scan.cu``.

Two modes.  With ``skip_from=0`` (the exact mode) the kernel equals the
plain version bit for bit.  With ``skip_from > 0`` (the skipping mode) a
problem whose state minimum reaches ``skip_from`` at some level leaves the
kernel there, and the rest of its B column is DEV_INF: the result equals the
plain version wherever that is below DEV_INF_THRESH and is >= DEV_INF_THRESH
wherever that is (``ops.common.equal_mod_inf``), provided ``skip_from`` comes
from ``ops.common.dead_state_threshold``.  The plain version never skips.
"""

from __future__ import annotations

import torch

from .. import _build
from .common import DEV_INF, DEV_INF_THRESH, I32, check_tensor
from .modules import module_scan_torch

MAX_W = 32 * 64  # the widest instantiation of the kernel
MAX_TABLE_BYTES = 227 * 1024  # the shared memory one block can have


def module_scan(seedT, lut, sdo, sde, pchar, pmask, io, ie, *, fwd: bool,
                allow_sdel: bool, skip_from: int = 0):
    """B (L+1, NB, C): per-level exit minima of each (entry row, column).
    `skip_from` is 0 (exact) or a value of ``common.dead_state_threshold``."""
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
    if skip_from != 0 and not DEV_INF_THRESH <= skip_from <= DEV_INF:
        raise ValueError(f"skip_from must be 0 or in [2^29, 2^30 - 1], got {skip_from}")
    if dev.type == "cpu":
        return module_scan_torch(seedT, lut, sdo, sde, pchar, pmask, io, ie,
                                 fwd=fwd, allow_sdel=allow_sdel)
    if dev.type != "cuda":
        raise ValueError(f"module_scan runs on cpu or cuda, not {dev}")
    if W < 1 or W > MAX_W:
        raise ValueError(f"module_scan kernel takes 1 <= W <= {MAX_W}, got {W}")
    if (A + 3) * ((W + 31) // 32) * 128 > MAX_TABLE_BYTES:
        raise ValueError(f"module_scan kernel: {A} LUT rows of {W} offsets exceed "
                         f"a block's shared memory")
    lib = _build.library()
    out = torch.empty((L + 1, NB, C), dtype=I32, device=dev)
    if NB and C:
        code = lib.tsa_module_scan(
            seedT.data_ptr(), lut.data_ptr(), sdo.data_ptr(), sde.data_ptr(),
            pchar.data_ptr(), pmask.data_ptr(), io.data_ptr(), ie.data_ptr(),
            out.data_ptr(), NB, C, W, L, A, int(fwd), int(allow_sdel),
            int(skip_from), _build.stream_ptr(dev),
        )
        _build.check(code, "module_scan")
        _build.launches["module_scan"] += 1
    return out
