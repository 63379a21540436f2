"""The module scan: the CUDA kernel's wrappers.

`module_scan` takes the inputs of the Pallas kernel
``tsalign_tpu/ops/pallas_module.py::module_scan_pallas``: seedT (NB, C, W),
lut (A, C, W), sdo/sde (C, W), pchar/pmask/io/ie (L, NB), all int32, and
returns B (L+1, NB, C).  `module_scan_diag` takes a same-sequence kind's
problem, the diagonal of that grid: seed (NB, W), lut (A, NB, W) with row b
reading ``lut[pchar[b], b]``, sdo/sde (NB, W) and the same per-level tables,
and returns B (L+1, NB), what ``ops.modules.module_scan_torch`` computes for
2-D seeds.  Either takes a pair axis: every input and the output with a
leading axis of P problem sets of one shape, run in one launch (counted as
``module_scan_pairs`` when P > 1; the diagonal mode's as ``module_scan_diag``);
the result is then a view of the kernel's output, whose problem axis holds
the sets side by side.  For tensors
on the CPU they run the plain version ``ops.modules.module_scan_torch`` (a
set at a time); for tensors on a CUDA device they launch
``csrc/module_scan.cuh``'s kernel (entry points in ``csrc/module_scan.cu``
and, for the global-memory variant, ``csrc/module_scan_gmem.cu``).

Two modes.  With ``skip_from=0`` (the exact mode) the kernel equals the
plain version bit for bit.  With ``skip_from > 0`` (the skipping mode) a
problem whose state minimum reaches ``skip_from`` at some level leaves the
kernel there, and the rest of its B column is DEV_INF: the result equals the
plain version wherever that is below DEV_INF_THRESH and is >= DEV_INF_THRESH
wherever that is (``ops.common.equal_mod_inf``), provided ``skip_from`` comes
from ``ops.common.dead_state_threshold``.  The plain version never skips, and
the diagonal mode runs the exact mode only.

A module of up to 2048 offsets runs a problem in one warp; a wider one in
T = ceil(W / 2048) warps of a block.  The tables live in a block's shared
memory, ``(A + 3) * 32 T K * 4`` bytes (K the offsets a lane), up to about
6,300 offsets at A = 6 rows; where they do not fit, the launch takes the
kernel's global-memory variant, whose tables stay in device memory (counted
as ``module_scan_gmem``, in either mode).  Its cap is 8 warps a problem,
16,384 offsets; beyond it the wrapper raises ``ValueError``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .common import DEV_INF, DEV_INF_THRESH, I32, check_tensor
from .modules import module_scan_torch

def launch_plan(W: int, A: int, diag: bool = False):
    """(K offsets a lane, T warps a problem, G problems a block, shared
    bytes, gmem) of a kernel launch, gmem true where the tables stay in
    device memory; ValueError past 8 warps a problem (W > 16,384)."""
    lib = _build.library()
    K, T, G, gmem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    nbytes = ctypes.c_longlong()
    code = lib.tsa_module_scan_plan(W, A, int(diag), ctypes.byref(K), ctypes.byref(T),
                                    ctypes.byref(G), ctypes.byref(nbytes), ctypes.byref(gmem))
    if code != 0:
        raise ValueError(f"module_scan kernel: a module of {W} offsets ({A} LUT rows) exceeds "
                         f"8 warps a problem (16,384 offsets)")
    return K.value, T.value, G.value, nbytes.value, bool(gmem.value)


def _check_skip(skip_from):
    if skip_from != 0 and not DEV_INF_THRESH <= skip_from <= DEV_INF:
        raise ValueError(f"skip_from must be 0 or in [2^29, 2^30 - 1], got {skip_from}")


def module_scan(seedT, lut, sdo, sde, pchar, pmask, io, ie, *, fwd: bool,
                allow_sdel: bool, skip_from: int = 0):
    """B (L+1, NB, C): per-level exit minima of each (entry row, column);
    with a leading pair axis on every input, (P, L+1, NB, C).  `skip_from`
    is 0 (exact) or a value of ``common.dead_state_threshold``."""
    pairs = seedT.dim() == 4
    lead = 1 if pairs else 0
    if seedT.dim() != 3 + lead or lut.dim() != 3 + lead or pchar.dim() != 2 + lead:
        raise ValueError("module_scan takes seedT ([P,] NB, C, W), lut ([P,] A, C, W), "
                         "pchar ([P,] L, NB)")
    P = seedT.shape[0] if pairs else 1
    pre = (P,) if pairs else ()
    NB, C, W = seedT.shape[lead:]
    A = lut.shape[lead]
    L = pchar.shape[lead]
    dev = seedT.device
    check_tensor("seedT", seedT, pre + (NB, C, W), dev)
    check_tensor("lut", lut, pre + (A, C, W), dev)
    for name, t in (("sdo", sdo), ("sde", sde)):
        check_tensor(name, t, pre + (C, W), dev)
    for name, t in (("pchar", pchar), ("pmask", pmask), ("io", io), ("ie", ie)):
        check_tensor(name, t, pre + (L, NB), dev)
    _check_skip(skip_from)
    if dev.type == "cpu":
        if not pairs:
            return module_scan_torch(seedT, lut, sdo, sde, pchar, pmask, io, ie,
                                     fwd=fwd, allow_sdel=allow_sdel)
        return torch.stack([
            module_scan_torch(*(t[z] for t in (seedT, lut, sdo, sde, pchar, pmask, io, ie)),
                              fwd=fwd, allow_sdel=allow_sdel) for z in range(P)])
    if dev.type != "cuda":
        raise ValueError(f"module_scan runs on cpu or cuda, not {dev}")
    if W < 1:
        raise ValueError(f"module_scan kernel takes W >= 1, got {W}")
    _, T, G, _, gmem = launch_plan(W, A)
    NBs, levels = _sets_side_by_side(pairs, G, pchar, pmask, io, ie)
    out = torch.empty((L + 1, P * NBs, C), dtype=I32, device=dev)
    if P and NB and C:
        lib = _build.library()
        name = ("module_scan_gmem" if gmem else "module_scan_pairs" if P > 1
                else "module_scan_wide" if T > 1 else "module_scan")
        entry = lib.tsa_module_scan_gmem if gmem else lib.tsa_module_scan
        code = entry(
            seedT.data_ptr(), lut.data_ptr(), sdo.data_ptr(), sde.data_ptr(),
            *(t.data_ptr() for t in levels), out.data_ptr(), P, NB, C, W, L, A,
            int(fwd), int(allow_sdel), int(skip_from), 0, _build.stream_ptr(dev),
        )
        _build.check(code, name)
        _build.launches[name] += 1
    return out.view(L + 1, P, NBs, C)[:, :, :NB].transpose(0, 1) if pairs else out


def _sets_side_by_side(pairs: bool, G: int, *tables):
    """(NBs, tables): the per-level tables as the kernel reads them, (L, P NBs)
    with the sets side by side on the problem axis, each set's NB problems
    padded to NBs, a multiple of the G problems of a block when P > 1 (a copy
    only under a pair axis; the padding is not read)."""
    if not pairs:
        return tables[0].shape[-1], tables
    P, L, NB = tables[0].shape
    NBs = NB if P == 1 else -(-NB // G) * G
    out = []
    for t in tables:
        side = torch.zeros((L, P, NBs), dtype=t.dtype, device=t.device)
        side[:, :, :NB] = t.transpose(0, 1)
        out.append(side.view(L, P * NBs))
    return NBs, tuple(out)


def module_scan_diag(seed, lut, sdo, sde, pchar, pmask, io, ie, *, fwd: bool,
                     allow_sdel: bool):
    """B (L+1, NB) of a same-sequence kind's module (the diagonal mode, exact);
    with a leading pair axis on every input, (P, L+1, NB)."""
    pairs = seed.dim() == 3
    lead = 1 if pairs else 0
    if seed.dim() != 2 + lead or lut.dim() != 3 + lead or pchar.dim() != 2 + lead:
        raise ValueError("module_scan_diag takes seed ([P,] NB, W), lut ([P,] A, NB, W), "
                         "pchar ([P,] L, NB)")
    P = seed.shape[0] if pairs else 1
    pre = (P,) if pairs else ()
    NB, W = seed.shape[lead:]
    A = lut.shape[lead]
    L = pchar.shape[lead]
    dev = seed.device
    check_tensor("seed", seed, pre + (NB, W), dev)
    check_tensor("lut", lut, pre + (A, NB, W), dev)
    for name, t in (("sdo", sdo), ("sde", sde)):
        check_tensor(name, t, pre + (NB, W), dev)
    for name, t in (("pchar", pchar), ("pmask", pmask), ("io", io), ("ie", ie)):
        check_tensor(name, t, pre + (L, NB), dev)
    if dev.type == "cpu":
        if not pairs:
            return module_scan_torch(seed, lut, sdo, sde, pchar, pmask, io, ie,
                                     fwd=fwd, allow_sdel=allow_sdel)
        return torch.stack([
            module_scan_torch(*(t[z] for t in (seed, lut, sdo, sde, pchar, pmask, io, ie)),
                              fwd=fwd, allow_sdel=allow_sdel) for z in range(P)])
    if dev.type != "cuda":
        raise ValueError(f"module_scan_diag runs on cpu or cuda, not {dev}")
    if W < 1:
        raise ValueError(f"module_scan_diag kernel takes W >= 1, got {W}")
    _, _, G, _, gmem = launch_plan(W, A, diag=True)
    NBs, levels = _sets_side_by_side(pairs, G, pchar, pmask, io, ie)
    out = torch.empty((L + 1, P * NBs), dtype=I32, device=dev)
    if P and NB:
        lib = _build.library()
        name = "module_scan_gmem" if gmem else "module_scan_diag"
        entry = lib.tsa_module_scan_gmem if gmem else lib.tsa_module_scan
        code = entry(
            seed.data_ptr(), lut.data_ptr(), sdo.data_ptr(), sde.data_ptr(),
            *(t.data_ptr() for t in levels), out.data_ptr(), P, NB, 1, W, L, A,
            int(fwd), int(allow_sdel), 0, 1, _build.stream_ptr(dev),
        )
        _build.check(code, name)
        _build.launches[name] += 1
    return out.view(L + 1, P, NBs)[:, :, :NB].transpose(0, 1) if pairs else out
