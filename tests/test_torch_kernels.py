"""The port's CUDA kernels against their plain torch versions on the card.

This file imports no JAX, so it runs on a machine that has a CUDA card and
no JAX:

    python -m pytest tests/test_torch_kernels.py -m cuda -q

Every input is seeded and holds DEV_INF and DEV_INF - 1 entries; the
tolerance is 0 (``torch.equal``).  Without a card the tests skip, and the
plain versions are held against the JAX package by test_torch_sweep.py and
test_torch_modules.py.
"""

import pytest
import torch

from tsalign_tpu_torch import _build
from tsalign_tpu_torch.ops.common import DEV_INF, sat_add
from tsalign_tpu_torch.ops.module_scan import module_scan
from tsalign_tpu_torch.ops.modules import module_scan_torch
from tsalign_tpu_torch.ops.sweep import (sweep_flanked, sweep_flanked_torch, sweep_flankless,
                                         sweep_flankless_torch)

from torch_util import cuda  # noqa: F401


def _costs(g, shape, lo, hi, p_inf=0.0, p_inf1=0.0):
    x = torch.randint(lo, hi, shape, generator=g, dtype=torch.int32)
    u = torch.rand(shape, generator=g)
    x[u < p_inf] = DEV_INF
    x[(u >= p_inf) & (u < p_inf + p_inf1)] = DEV_INF - 1
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,Wq", [(17, 1), (40, 33), (301, 700), (65, 1500)])
def test_sweep_kernel_matches_plain_on_card(cuda, n_rows, Wq):
    g = torch.Generator().manual_seed(n_rows)
    sub = _costs(g, (n_rows, Wq), 0, 7, 0.02, 0.02)
    dd = _costs(g, (n_rows, 2), 0, 6, 0.02)
    seeds = _costs(g, (n_rows, 3, Wq), 0, 60, 0.9, 0.05)
    io = _costs(g, (Wq,), 0, 6, 0.02)
    ie = _costs(g, (Wq,), 0, 3, 0.02)
    args = [a.to(cuda) for a in (sub, dd, seeds, io, ie)]
    before = _build.launches["sweep_flankless"]
    got = sweep_flankless(*args)
    assert _build.launches["sweep_flankless"] == before + 1
    assert torch.equal(got, sweep_flankless_torch(*args))


def flanked_inputs(g, n_rows, Wq, F):
    """Seeded inputs of the flanked sweep in the row-major layout, with
    DEV_INF and DEV_INF - 1 entries and seeds in every layer."""
    subs = _costs(g, (3, n_rows, Wq), 0, 7, 0.02, 0.02)
    subs[:, 0] = DEV_INF
    dd = _costs(g, (n_rows, 6), 0, 6, 0.02)
    seeds = _costs(g, (n_rows, 3 * F, Wq), 0, 60, 0.9, 0.05)
    io = _costs(g, (3, Wq), 0, 6, 0.02)
    ie = _costs(g, (3, Wq), 0, 3, 0.02)
    return subs, dd, seeds, io, ie


@pytest.mark.cuda
@pytest.mark.parametrize("L,R,climb", [(0, 1, True), (1, 0, True), (1, 0, False), (2, 2, True),
                                       (2, 2, False), (5, 5, True), (7, 8, True)])
@pytest.mark.parametrize("n_rows,Wq", [(17, 1), (40, 33), (90, 513), (33, 2100)])
def test_flanked_sweep_kernel_matches_plain_on_card(cuda, n_rows, Wq, L, R, climb):
    g = torch.Generator().manual_seed(1000 * L + 100 * R + n_rows + int(climb))
    F = L + R + 1
    subs, dd, seeds, io, ie = (a.to(cuda) for a in flanked_inputs(g, n_rows, Wq, F))
    kw = dict(L=L, R=R, climb=climb)
    before = _build.launches["sweep_flanked"]
    got = sweep_flanked(subs, dd, seeds, io, ie, **kw)
    assert _build.launches["sweep_flanked"] == before + 1
    want = sweep_flanked_torch(subs, dd, seeds, io, ie, **kw)
    assert got.is_contiguous() and torch.equal(got, want)
    # The engine's plane-major field layout, read and written in place.
    planes = seeds.permute(1, 0, 2).contiguous()
    got_p = sweep_flanked(subs, dd, planes.permute(1, 0, 2), io, ie, **kw)
    assert got_p.permute(1, 0, 2).is_contiguous() and torch.equal(got_p, want)


@pytest.mark.cuda
def test_flanked_sweep_kernel_refuses_too_many_layers(cuda):
    g = torch.Generator().manual_seed(5)
    subs, dd, seeds, io, ie = (a.to(cuda) for a in flanked_inputs(g, 4, 5, 17))
    with pytest.raises(ValueError):
        sweep_flanked(subs, dd, seeds, io, ie, L=8, R=8, climb=True)


@pytest.mark.cuda
@pytest.mark.parametrize("allow_sdel", [True, False])
@pytest.mark.parametrize("fwd", [True, False])
@pytest.mark.parametrize("W", [5, 201, 1101])
def test_module_scan_kernel_matches_plain_on_card(cuda, fwd, allow_sdel, W):
    NB, C, L, A = 16, 8, 12, 6
    g = torch.Generator().manual_seed(W + 2 * int(fwd) + int(allow_sdel))
    # Finite seeds >= L keep every value nonnegative (see ops/common.py).
    seedT = _costs(g, (NB, C, W), L, L + 40, 0.5, 0.05)
    lut = _costs(g, (A, C, W), -1, 7, 0.05, 0.05)
    lut[A - 1] = DEV_INF
    sdo = _costs(g, (C, W), 0, 6, 0.05)
    sde = _costs(g, (C, W), 0, 3, 0.05)
    pchar = torch.randint(0, A, (L, NB), generator=g, dtype=torch.int32)
    pmask = torch.where(torch.rand((L, NB), generator=g) < 0.1, DEV_INF, 0).to(torch.int32)
    io = sat_add(_costs(g, (A,), -1, 6)[pchar.long()], pmask)
    ie = sat_add(_costs(g, (A,), -1, 3)[pchar.long()], pmask)
    t = [a.to(cuda) for a in (seedT, lut, sdo, sde, pchar, pmask, io, ie)]
    kw = dict(fwd=fwd, allow_sdel=allow_sdel)
    assert torch.equal(module_scan(*t, **kw), module_scan_torch(*t, **kw))
