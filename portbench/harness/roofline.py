"""The least time of a kernel launch from the work its inputs need, and the
published peaks of one NVIDIA H100 (SXM, 700 W) it is held against.

Frozen from commit a358c37: ``bound`` and the peaks from ``chip_smoke.py``
(``HBM_BYTES_PER_S``, ``INT32_OPS_PER_S``, ``bound``), the module scan's
count from ``chip_smoke.py::module_scan_work`` (here the first dead level of
each problem is read from the kernel's own output in its skipping mode,
which equals the plain version's below the skip threshold), the assembly's
from ``chip_smoke.py::assembly_bound`` and
``tests/torch_cases.py::assembly_bytes``.  Later changes to those files do
not move this benchmark's yardstick.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4 * 2  # 64 of an SM's 128 lanes, two operations a DPX instruction

# Module scan, per (entry row, column, offset) and level: close 6 (open min,
# clamped add, the chain's add, clamp and min) with secondary deletions on,
# emit 3, step 12 (LUT add and clamp, min3, the insertion's six, the
# diagonal's clamped add).
SCAN_CLOSE_OPS, SCAN_EMIT_OPS, SCAN_STEP_OPS = 6, 3, 12
# Assembly: a window minimum costs 3 operations a position at most (fewer
# for narrow windows), a segment's saturating add and minimum 3, the output
# terms 6.
ASSEMBLY_OPS_PER_WINDOW, ASSEMBLY_OPS_PER_SEGMENT, ASSEMBLY_OPS_PER_OUTPUT = 3, 3, 6


def least_seconds(n_bytes, n_ops):
    """The larger of bytes over the memory rate and integer operations over
    the int32 rate; a device scalar where `n_ops` is one (no host sync)."""
    if hasattr(n_ops, "clamp"):
        return (n_ops / INT32_OPS_PER_S).clamp(min=n_bytes / HBM_BYTES_PER_S)
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / INT32_OPS_PER_S)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def module_scan_work(inputs, out, *, allow_sdel: bool, skip_from: int, diag: bool):
    """(bytes, operations) of one module-scan launch: every input read once
    and B written once; the levels a problem has to run, up to its first
    level whose minimum reaches `skip_from` in the skipping mode (all L + 1
    in the exact mode).  `out` is the launch's B: (L+1, NB, C), with a
    leading pair axis (P, L+1, NB, C), or (L+1, NB) in the diagonal mode.
    The operation count is returned as a device scalar (no host sync)."""
    seed, lut, sdo, sde, pchar, pmask, io, ie = inputs
    W = seed.shape[-1]
    B = out
    if diag:
        B = B[..., None]
    if B.dim() == 3:
        B = B[None]
    P, L1, NB, C = B.shape
    close_emit = (SCAN_CLOSE_OPS if allow_sdel else 0) + SCAN_EMIT_OPS
    if skip_from > 0:
        dead = B >= skip_from
        first = dead.int().argmax(dim=1).masked_fill_(~dead.any(dim=1), L1 - 1)
        levels = (first + 1).sum()  # int64, on the device
    else:
        levels = P * NB * C * L1
    ops = W * (levels * close_emit + (levels - P * NB * C) * SCAN_STEP_OPS)
    n_bytes = nbytes(*inputs) + 4 * P * L1 * NB * C
    return n_bytes, ops


def assembly_bytes(km, n_rows, C, span):
    """The bytes one chunk's assembly depends on, each read or written once:
    the entries of B that the rows' shear reaches (level l <= L_read of row
    p2 - l >= 0, for p2 < n_rows; C columns each for a cross kind), for a
    same-sequence kind the entry columns those rows read (all n_rows), each
    row's slab window of `span` ints read and written, and the length and
    anti tables."""
    levels = min(km.L_read, n_rows - 1) + 1
    reached = levels * n_rows - levels * (levels - 1) // 2  # sum of n_rows - l, l < levels
    entries = reached + n_rows * C if km.same_seq else reached * C
    return 4 * (entries + 2 * n_rows * span + km.L_read + 1 + km.S)


def assembly_work(A_chunks, kms, spans):
    """(bytes, operations) of one assembly launch over its pairs."""
    n_bytes = ops = 0
    for A, km, span in zip(A_chunks, kms, spans):
        n_rows, C = A.shape
        n_bytes += assembly_bytes(km, n_rows, C, int(span))
        ah = km.ah_real if km.padded else km.anti_hi
        p2 = np.arange(n_rows)
        minima = 0  # a (column, output)'s window operations over the rows
        for plan in km.plans:
            w = plan.b - plan.a + 1
            if plan.positive:
                lo, hi = np.clip(p2 - (ah - plan.b), 0, w), w - 1
            else:
                lo, hi = 0, np.clip(p2 + plan.b - km.anti_lo, -1, w - 1)
            minima += int(np.clip(hi - lo, 0, ASSEMBLY_OPS_PER_WINDOW).sum())
        ops += C * km.S * (minima + n_rows * (ASSEMBLY_OPS_PER_SEGMENT * len(km.plans)
                                              + ASSEMBLY_OPS_PER_OUTPUT))
    return n_bytes, ops
