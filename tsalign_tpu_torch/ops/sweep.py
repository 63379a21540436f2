"""The primary sweeps: plain torch versions and the CUDA kernels' wrappers.

`sweep_flankless_torch` is the plain version of the JAX package's ``_sweep_jit``
at F = 1 (``ops/jax_primary.py``), written row by row like the Pallas kernel
``ops/pallas_sweep.py::_sweep_kernel``.  `sweep_flankless` runs it for tensors
on the CPU and launches ``csrc/sweep.cu`` for tensors on a CUDA device.
Inputs and output use the Pallas layout: sub_rows (n_rows, Wq),
ddrows (n_rows, 2), seeds (n_rows, 3, Wq), io/ie (Wq,) -> M (n_rows, 3, Wq),
all int32.

`sweep_flanked_torch` is the plain version of ``_sweep_jit``'s ``row_step``
over F = L + R + 1 flank layers, on the layout of the Pallas kernel
``ops/pallas_sweep.py::sweep_pallas_flanked``: subs (3, n_rows, Wq) for the
(primary, left-flank, right-flank) tables, ddrows (n_rows, 6) del open/extend
per table, seeds (n_rows, 3F, Wq) layer-major (plane 3 * fi + gap), io/ie
(3, Wq) -> M (n_rows, 3F, Wq).  `sweep_flanked` runs it for tensors on the CPU
and launches ``csrc/sweep.cu`` for tensors on a CUDA device: one kernel serves
both sweeps, the flankless one as its F = 1 case (`sweep_flankless_torch`
equals `sweep_flanked_torch` at L = R = 0 on the same inputs).

The seeds of either sweep may be row-major (contiguous) or plane-major (a
``permute(1, 0, 2)`` view of a contiguous (planes, n_rows, Wq) tensor, the
engine's field layout); the kernel addresses both through a row stride and a
plane stride, and M comes back in the layout of the seeds.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .common import (DEV_INF, I32, check_extension, check_tensor, minplus_scan, sat_add,
                     shift_last)
from .primary_sweep import GAP_DEL, GAP_INS, GAP_NONE


def sweep_flankless_torch(sub_rows, ddrows, seeds, io, ie):
    """Plain torch flankless sweep (any device)."""
    n_rows, Wq = sub_rows.shape
    out = torch.empty_like(seeds)  # keeps the seeds' layout
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


def _check_seeds(seeds, n_rows, planes, Wq, dev):
    """Raise unless `seeds` is an int32 (n_rows, planes, Wq) tensor on `dev`,
    row-major (contiguous) or plane-major (a ``permute(1, 0, 2)`` view of a
    contiguous (planes, n_rows, Wq) tensor)."""
    plane_major = (
        isinstance(seeds, torch.Tensor) and seeds.dim() == 3
        and not seeds.is_contiguous() and seeds.permute(1, 0, 2).is_contiguous()
    )
    check_tensor("seeds", seeds.permute(1, 0, 2) if plane_major else seeds,
                 (planes, n_rows, Wq) if plane_major else (n_rows, planes, Wq), dev)


def _launch(name, subs, ddrows, seeds, io, ie, L, R, climb, warps: int = 0):
    """Launch the sweep (its two re-ordering kernels and the wavefront
    between them, as one call); M in the layout of the seeds.  `warps` (1 .. 8)
    holds the block to fewer warps than the launch would take (0), for the
    tests and the probe: the wrappers below never pass it."""
    n_rows, planes, Wq = seeds.shape
    dev = seeds.device
    out = torch.empty_strided(seeds.shape, seeds.stride(), dtype=I32, device=dev)
    if n_rows and Wq:
        lib = _build.library()
        n_in, n_out = ctypes.c_longlong(), ctypes.c_longlong()
        _build.check(lib.tsa_sweep_scratch(n_rows, Wq, planes // 3, ctypes.byref(n_in),
                                           ctypes.byref(n_out)), name + " (scratch)")
        # the data in the order the wavefront reads and writes it
        skewed_in = torch.empty(n_in.value, dtype=I32, device=dev)
        skewed_out = torch.empty(n_out.value, dtype=I32, device=dev)
        code = lib.tsa_sweep(
            subs.data_ptr(), ddrows.data_ptr(), seeds.data_ptr(), io.data_ptr(),
            ie.data_ptr(), out.data_ptr(), skewed_in.data_ptr(), skewed_out.data_ptr(),
            n_rows, Wq, L, R, int(bool(climb)), ddrows.shape[1], seeds.stride(0),
            seeds.stride(1), warps, _build.stream_ptr(dev),
        )
        _build.check(code, name)
        _build.launches[name] += 1
    return out


def sweep_flankless(sub_rows, ddrows, seeds, io, ie):
    """Flankless sweep: the plain version on the CPU, the kernel on CUDA."""
    if sub_rows.dim() != 2:
        raise ValueError("sub_rows must be (n_rows, Wq)")
    n_rows, Wq = sub_rows.shape
    dev = sub_rows.device
    check_tensor("sub_rows", sub_rows, (n_rows, Wq), dev)
    check_tensor("ddrows", ddrows, (n_rows, 2), dev)
    _check_seeds(seeds, n_rows, 3, Wq, dev)
    check_tensor("io", io, (Wq,), dev)
    check_tensor("ie", ie, (Wq,), dev)
    if dev.type == "cpu":
        return sweep_flankless_torch(sub_rows, ddrows, seeds, io, ie)
    if dev.type != "cuda":
        raise ValueError(f"sweep_flankless runs on cpu or cuda, not {dev}")
    return _launch("sweep_flankless", sub_rows, ddrows, seeds, io, ie, 0, 0, False)


MAX_FLANK_LAYERS = 16  # the deepest layer stack the flanked kernel is held to


def _climb_table(fi: int, L: int, R: int, climb: bool):
    """Table index (1 left flank, 2 right flank) of the climb edges into
    layer index fi from fi - 1, or None where the layer takes seeds only."""
    f = fi - R
    if (-R < f < 0) or (f == 0 and R > 0):
        return 2
    if f > 0 and climb:
        return 1
    return None


def sweep_flanked_torch(subs, ddrows, seeds, io, ie, *, L: int, R: int, climb: bool):
    """Plain torch flank-layered sweep (any device)."""
    _, n_rows, Wq = subs.shape
    F = L + R + 1
    out = torch.empty_like(seeds)
    prev = torch.full((3 * F, Wq), DEV_INF, dtype=I32, device=subs.device)
    check_extension("sweep_flanked_torch", ie[0])
    ext_into = shift_last(ie[0], 1, True)

    def diag_from(src, sub_row):
        return torch.clamp_max(
            shift_last(src.amin(dim=0), 1, True) + shift_last(sub_row, 1, True), DEV_INF
        )

    def del_from(src, d_open, d_ext):
        return torch.minimum(
            sat_add(torch.minimum(src[GAP_NONE], src[GAP_INS]), d_open),
            sat_add(src[GAP_DEL], d_ext),
        )

    for r in range(n_rows):
        row = out[r]
        for fi in range(F):
            lo = 3 * fi
            none_c = seeds[r, lo + GAP_NONE]
            ins_c = seeds[r, lo + GAP_INS]
            del_c = seeds[r, lo + GAP_DEL]
            if fi == R:
                none_c = torch.minimum(none_c, diag_from(prev[lo : lo + 3], subs[0, r]))
                del_c = torch.minimum(
                    del_c, del_from(prev[lo : lo + 3], ddrows[r, 0], ddrows[r, 1])
                )
            ct = _climb_table(fi, L, R, climb)
            if ct is not None:
                below = prev[lo - 3 : lo]
                none_c = torch.minimum(none_c, diag_from(below, subs[ct, r]))
                del_c = torch.minimum(
                    del_c, del_from(below, ddrows[r, 2 * ct], ddrows[r, 2 * ct + 1])
                )
                # climb insertion: one step from the current row of the
                # layer below, which the bottom-up order has finished
                cur = row[lo - 3 : lo]
                o = sat_add(torch.minimum(cur[GAP_NONE], cur[GAP_DEL]), io[ct])
                e = sat_add(cur[GAP_INS], ie[ct])
                ins_c = torch.minimum(ins_c, shift_last(torch.minimum(o, e), 1, True))
            if fi == R:
                open_c = shift_last(sat_add(torch.minimum(none_c, del_c), io[0]), 1, True)
                ins_c = minplus_scan(torch.minimum(ins_c, open_c), ext_into)
            row[lo + GAP_NONE] = none_c
            row[lo + GAP_INS] = ins_c
            row[lo + GAP_DEL] = del_c
        prev = row
    return out


def sweep_flanked(subs, ddrows, seeds, io, ie, *, L: int, R: int, climb: bool):
    """Flank-layered sweep: the plain version on the CPU, the kernel on CUDA."""
    if subs.dim() != 3 or subs.shape[0] != 3:
        raise ValueError("subs must be (3, n_rows, Wq)")
    if L < 0 or R < 0:
        raise ValueError("flank lengths must be >= 0")
    F = L + R + 1
    if F > MAX_FLANK_LAYERS:
        raise ValueError(f"sweep_flanked takes at most {MAX_FLANK_LAYERS} flank layers, got {F}")
    _, n_rows, Wq = subs.shape
    dev = subs.device
    check_tensor("subs", subs, (3, n_rows, Wq), dev)
    check_tensor("ddrows", ddrows, (n_rows, 6), dev)
    check_tensor("io", io, (3, Wq), dev)
    check_tensor("ie", ie, (3, Wq), dev)
    _check_seeds(seeds, n_rows, 3 * F, Wq, dev)
    if dev.type == "cpu":
        return sweep_flanked_torch(subs, ddrows, seeds, io, ie, L=L, R=R, climb=bool(climb))
    if dev.type != "cuda":
        raise ValueError(f"sweep_flanked runs on cpu or cuda, not {dev}")
    return _launch("sweep_flanked", subs, ddrows, seeds, io, ie, L, R, climb)


def dpx_chain_clocks(device, n: int = 1 << 20) -> float:
    """Clocks an instruction of `n` dependent ``__viaddmin_s32`` in one thread
    of `device` (a CUDA device): the latency of the instruction that a sweep's
    dependency chain is made of."""
    n -= n % 16
    out = torch.zeros(2, dtype=torch.int64, device=device)
    lib = _build.library()
    for _ in range(2):  # the first run warms the instruction cache
        _build.check(lib.tsa_dpx_chain(out.data_ptr(), n, _build.stream_ptr(out.device)),
                     "dpx_chain")
    return int(out[0]) / n
