"""Seeded cases of the reentry assembly, shared by the port's tests and
chip_smoke.py.

It imports the port and torch, never JAX or pytest, so that chip_smoke.py
(which puts ``tests/`` on ``sys.path``) imports it on the card as the tests
do: ``from torch_cases import ...``.
"""

from __future__ import annotations

import torch

from tsalign_tpu_torch.ops.common import DEV_INF, DEV_INF_THRESH
from tsalign_tpu_torch.ops.modules import KindModule
from tsalign_tpu_torch.ops.tsm_modules import make_kind_spec


def negative_costs(CostFunction, INF) -> dict:
    """The cost functions of a configuration whose ldiff segments,
    anti-primary gaps and length costs go negative (a value near DEV_INF
    then depends on the order of the saturating adds), as fields for
    ``dataclasses.replace``; `CostFunction` and `INF` are the port's or the
    JAX package's."""
    low = -(2 ** 62)
    return dict(
        length_difference_costs=CostFunction(
            [(low, INF), (-9, 2), (-3, -2), (0, -1), (1, -3), (6, 1), (12, INF)]),
        forward_anti_primary_gap_costs=CostFunction(
            [(low, INF), (-8, -1), (0, 0), (3, -2), (20, INF)]),
        reverse_anti_primary_gap_costs=CostFunction(
            [(low, INF), (-7, 1), (-1, -3), (2, 0), (20, INF)]),
        length_costs=CostFunction([(0, INF), (2, -1), (5, 3), (9, -2)]),
    )


def rand_costs(gen, shape, lo, hi, p_inf=0.0, p_inf1=0.0):
    """Seeded int32 costs in [lo, hi) with DEV_INF / DEV_INF - 1 entries, on
    the CPU."""
    x = torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)
    u = torch.rand(shape, generator=gen)
    x[u < p_inf] = DEV_INF
    x[(u >= p_inf) & (u < p_inf + p_inf1)] = DEV_INF - 1
    return x


def assembly_kinds(cfg, ref, qry, chunk, real=None):
    """The active kind modules of every kind of a pair (int8 codes); with
    `real` = (n_r, n_q) the pair is poison-padded beyond those lengths."""
    n_r, n_q = len(ref), len(qry)
    kw = dict(sdel_budget=16)
    if real is not None:
        kw.update(n_ref_real=real[0], n_qry_real=real[1])
    out = []
    for pk, sk, dk in [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]:
        spec = make_kind_spec(cfg, n_r, n_q, pk, sk, dk, **kw)
        if spec is None:
            continue
        km = KindModule(spec, cfg, ref, qry, 0, n_q if pk == 0 else n_r, chunk=chunk)
        if km.active:
            out.append(km)
    return out


def assembly_inputs(gen, km, dev):
    """Seeded B at the levels the assembly reads (negative, DEV_INF,
    DEV_INF - 1 and [2^29, DEV_INF) entries) and entry columns of one chunk
    of kind `km`, on `dev`."""
    n_rows, C = km.n_p + 1, km.chunk
    A = rand_costs(gen, (n_rows, C), -3, 30, 0.3, 0.05)
    shape = (km.L_read + 1, n_rows) + (() if km.same_seq else (C,))
    B = rand_costs(gen, shape, -4, 40, 0.2, 0.05)
    big = torch.rand(shape, generator=gen) < 0.05
    B[big] = torch.randint(DEV_INF_THRESH, DEV_INF, (int(big.sum()),), generator=gen,
                           dtype=torch.int32)
    return B.to(dev), A.to(dev)


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


def slab_width(km):
    """The chunked route's slab width of kind `km` (the engine's)."""
    return max(0, -km.s_lo) + km.spec.n_anti + 1 + max(0, km.chunk - 1 + km.s_hi)


def assembly_slab(gen, km, seeded, dev):
    """A slab of kind `km` that holds DEV_INF, or seeded finite values beside
    DEV_INF (so that a kernel that overwrites in place of a minimum fails)."""
    shape = (km.n_p + 1, slab_width(km))
    if not seeded:
        return torch.full(shape, DEV_INF, dtype=torch.int32, device=dev)
    return rand_costs(gen, shape, -10, 60, 0.5).to(dev)
