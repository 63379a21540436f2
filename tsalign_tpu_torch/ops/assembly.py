"""The reentry assembly: the CUDA kernel's wrapper.

`assembly_fold` runs the reentry assembly of one chunk of a kind for the
chunk's live pairs (the pair axis) and min-folds each pair's result in place
into its slab: what ``tsalign_tpu/ops/jax_modules.py::_assembly`` and the
fold of ``_kind_all_chunks`` / ``_kind_sel_chunks`` compute.  For tensors on
the CPU it runs the plain version, `assembly_fold_torch`
(``ops.modules.assembly_torch`` and the same fold, a pair at a time); for
tensors on a CUDA device it launches ``csrc/assembly.cu`` once for all pairs
(counted as ``assembly``, or ``assembly_pairs`` when P > 1).  B holds the
L_read + 1 levels the windows read (``KindModule.L_read``), what the module
scan gives over ``KindModule.level_tables``.  The kernel equals the plain
version bit for bit, values in [2^29, DEV_INF] included.  Nothing falls
back: a build or launch error raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .common import DEV_INF, I32, to_device
from .modules import assembly_torch


def _check_bucket(kms):
    """Raise unless every pair's kind module has the bucket's shapes and
    segments (all but the real anti length are the bucket's)."""
    def key(km):
        return (km.same_seq, km.L, km.L_read, km.n_p, km.S, km.s_lo, km.plans, km.ldiff0,
                km.anti_lo, km.anti_hi, km.padded)

    if any(key(km) != key(kms[0]) for km in kms[1:]):
        raise ValueError("assembly_fold: the pairs of a launch must share the kind's "
                         "shapes and segments")


def assembly_fold(Bs, A_chunks, kms, ts, slabs, dest_base: int, dest=None):
    """Assemble one chunk for P pairs and fold it into their slabs, in place.

    For pair z: `Bs[z]` its module exit minima at the levels the assembly
    reads, (L_read+1, n_p+1, C) for a cross kind or (L_read+1, n_p+1) for a
    same-sequence kind (any strides); `A_chunks[z]` its (n_p+1, C) entry
    columns; `kms[z]` and `ts[z]` its kind module and
    that module's tables on the device; `slabs[z]` its (n_p+1, width) slab.
    Column c's s-slab lands at ``dest_base + c + s`` (the chunked route's
    diagonal min-fold) or, with `dest` a (P, C) host array of entry columns,
    at ``dest_base + dest[z, c] + s`` (the compact route)."""
    P = len(kms)
    if not (len(Bs) == len(A_chunks) == len(ts) == len(slabs) == P) or P == 0:
        raise ValueError("assembly_fold takes one B, entry chunk, table set and slab a pair")
    _check_bucket(kms)
    km0 = kms[0]
    n_rows, C = A_chunks[0].shape
    L, S = km0.L_read, km0.S
    dev = A_chunks[0].device
    b_shape = (L + 1, n_rows) + (() if km0.same_seq else (C,))
    for z in range(P):
        for name, t, shape in (("B", Bs[z], b_shape), ("A_chunk", A_chunks[z], (n_rows, C))):
            if t.dtype != I32 or tuple(t.shape) != shape or t.device != dev:
                raise ValueError(f"assembly_fold: {name} of pair {z} must be int32 {shape} on "
                                 f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        s = slabs[z]
        if s.dtype != I32 or s.dim() != 2 or s.shape[0] != n_rows or s.device != dev:
            raise ValueError(f"assembly_fold: slab of pair {z} must be int32 ({n_rows}, width) "
                             f"on {dev}")
    if dest is not None:
        dest = np.asarray(dest, dtype=np.int64)
        if dest.shape != (P, C):
            raise ValueError(f"assembly_fold: dest must have shape {(P, C)}, got {dest.shape}")
        lo = dest_base + dest.min(axis=1)
        span = dest.max(axis=1) - dest.min(axis=1) + S
    else:
        lo = np.full(P, dest_base, dtype=np.int64)
        span = np.full(P, C + S - 1, dtype=np.int64)
    if int(lo.min()) < 0 or any(int(lo[z] + span[z]) > slabs[z].shape[1] for z in range(P)):
        raise ValueError("assembly_fold: the fold runs off the slab")
    if dev.type == "cpu":
        assembly_fold_torch(Bs, A_chunks, kms, ts, slabs, dest_base, dest)
        return
    if dev.type != "cuda":
        raise ValueError(f"assembly_fold runs on cpu or cuda, not {dev}")
    _launch(Bs, A_chunks, kms, ts, slabs, dest_base, dest, lo, span)


def assembly_fold_torch(Bs, A_chunks, kms, ts, slabs, dest_base: int, dest=None):
    """The plain version of `assembly_fold` (no checks): `assembly_torch` a
    pair, then its fold, on any device."""
    for z, km in enumerate(kms):
        if dest is None:
            R_pad = assembly_torch(Bs[z], A_chunks[z], km, ts[z])
            cols = slice(dest_base, dest_base + R_pad.shape[1])
            slabs[z][:, cols] = torch.minimum(slabs[z][:, cols], R_pad)
        else:
            U = assembly_torch(Bs[z], A_chunks[z], km, ts[z], separate_cols=True)
            n_rows = U.shape[0]
            dev = slabs[z].device
            pos = (to_device(np.asarray(dest[z]), dev)[:, None]
                   + torch.arange(km.S, device=dev)[None, :] + dest_base)
            slabs[z].scatter_reduce_(1, pos.reshape(1, -1).expand(n_rows, -1),
                                     U.reshape(n_rows, -1), reduce="amin", include_self=True)


def _launch(Bs, A_chunks, kms, ts, slabs, dest_base, dest, lo, span):
    km0 = kms[0]
    P = len(kms)
    n_rows, C = A_chunks[0].shape
    dev = A_chunks[0].device
    if len(km0.plans) > 16:
        raise ValueError(f"assembly kernel: {len(km0.plans)} ldiff segments, at most 16")
    # (a copy freed on return is safe: the caching allocator reuses it in
    # stream order, after the launch)
    A_chunks = [a if a.stride(1) == 1 else a.contiguous() for a in A_chunks]
    if any(s.stride(1) != 1 for s in slabs):
        raise ValueError("assembly_fold: a slab's columns must be contiguous")
    d = None if dest is None else to_device(dest.astype(np.int32), dev)
    ptrs = np.zeros((P, 6), dtype=np.uint64)
    strides = np.zeros((P, 5), dtype=np.int64)
    ints = np.zeros((P, 4), dtype=np.int32)
    for z, km in enumerate(kms):
        B, t = Bs[z], ts[z]
        ptrs[z] = (B.data_ptr(), A_chunks[z].data_ptr(), t["length_vec"].data_ptr(),
                   t["anti_vec"].data_ptr(), 0 if d is None else d[z].data_ptr(),
                   slabs[z].data_ptr())
        strides[z] = (B.stride(0), B.stride(1), 0 if km0.same_seq else B.stride(2),
                      A_chunks[z].stride(0), slabs[z].stride(0))
        ints[z] = (dest_base, lo[z], span[z], km.ah_real if km.padded else km.anti_hi)
    segs = np.asarray([(p.a, p.b, min(p.cost, DEV_INF), int(p.positive))
                       for p in km0.plans], dtype=np.int32).reshape(-1, 4)
    lib = _build.library()
    name = "assembly_pairs" if P > 1 else "assembly"
    code = lib.tsa_assembly(
        ctypes.c_void_p(ptrs.ctypes.data), ctypes.c_void_p(strides.ctypes.data),
        ctypes.c_void_p(ints.ctypes.data),
        ctypes.c_void_p(segs.ctypes.data) if segs.size else None, len(km0.plans), P,
        n_rows, C, km0.L_read, km0.S, km0.s_lo, km0.anti_lo, int(km0.ldiff0),
        int(km0.same_seq), _build.stream_ptr(dev))
    _build.check(code, name)
    _build.launches[name] += 1
