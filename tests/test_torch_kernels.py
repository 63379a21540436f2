"""The port's CUDA kernels against their plain torch versions on the card.

This file imports no JAX, so it runs on a machine that has a CUDA card and
no JAX:

    python -m pytest tests/test_torch_kernels.py -m cuda -q

Every input is seeded and holds DEV_INF and DEV_INF - 1 entries; the
tolerance is 0 (``torch.equal``), and for the module scan's skipping mode
``equal_mod_inf`` (equal below 2^29, infinite where the plain version is).
Without a card the tests skip, and the
plain versions are held against the JAX package by test_torch_sweep.py and
test_torch_modules.py.
"""

import pytest
import torch

from tsalign_tpu_torch import _build
from tsalign_tpu_torch.ops.common import (DEV_INF, DEV_INF_THRESH, dead_state_threshold,
                                          equal_mod_inf, sat_add)
from tsalign_tpu_torch.ops.module_scan import launch_plan, module_scan, module_scan_diag
from tsalign_tpu_torch.ops.modules import module_scan_torch
from tsalign_tpu_torch.ops import sweep as sweep_ops
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


# Widths at the edges of a super-tile (32 lanes of 4 columns), of a block's 8
# super-tiles (one more goes through the scratch rows), and beyond.
STRIP_EDGES = [1, 127, 128, 129, 700, 1023, 1024, 1025, 1500]
# Warps a block: as the launch takes them (0), and held to fewer, so that a
# warp takes several super-tiles in turn.
WARPS = [0, 1, 3]


def flankless_inputs(g, n_rows, Wq, negative=False):
    sub = _costs(g, (n_rows, Wq), 0, 7, 0.02, 0.02)
    dd = _costs(g, (n_rows, 2), 0, 6, 0.02)
    seeds = _costs(g, (n_rows, 3, Wq), -40 if negative else 0, 60, 0.7 if negative else 0.9, 0.05)
    io = _costs(g, (Wq,), 0, 6, 0.02)
    ie = _costs(g, (Wq,), 0, 3, 0.02)
    return sub, dd, seeds, io, ie


def flankless_with(warps, sub, dd, seeds, io, ie):
    if not warps:
        return sweep_flankless(sub, dd, seeds, io, ie)
    return sweep_ops._launch("sweep_flankless", sub, dd, seeds, io, ie, 0, 0, False, warps=warps)


def flanked_with(warps, subs, dd, seeds, io, ie, *, L, R, climb):
    if not warps:
        return sweep_flanked(subs, dd, seeds, io, ie, L=L, R=R, climb=climb)
    return sweep_ops._launch("sweep_flanked", subs, dd, seeds, io, ie, L, R, climb, warps=warps)


def negate_some(seeds):
    return torch.where((seeds < 30) & (seeds % 3 == 0), -seeds, seeds)


@pytest.mark.cuda
@pytest.mark.parametrize("warps", WARPS)
@pytest.mark.parametrize("Wq", STRIP_EDGES)
def test_sweep_kernel_strip_edges_on_card(cuda, Wq, warps):
    """The edges of a super-tile and of a block's super-tiles, with the
    launch's warps and with fewer (more super-tiles than warps), row- and
    plane-major, on negative seeds beside infinite ones."""
    for n_rows in (1, 37):
        g = torch.Generator().manual_seed(Wq + n_rows)
        args = [a.to(cuda) for a in flankless_inputs(g, n_rows, Wq, negative=True)]
        want = sweep_flankless_torch(*args)
        assert torch.equal(flankless_with(warps, *args), want)
        planes = args[2].permute(1, 0, 2).contiguous().permute(1, 0, 2)
        got = flankless_with(warps, args[0], args[1], planes, args[3], args[4])
        assert got.stride() == planes.stride() and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("warps", WARPS)
@pytest.mark.parametrize("L,R,climb", [(2, 2, True), (0, 3, False), (7, 8, True)])
@pytest.mark.parametrize("Wq", STRIP_EDGES)
def test_flanked_sweep_kernel_strip_edges_on_card(cuda, Wq, L, R, climb, warps):
    """As above for the flank layers, up to F = 16."""
    for n_rows in (1, 19):
        g = torch.Generator().manual_seed(Wq + n_rows + L)
        subs, dd, seeds, io, ie = (a.to(cuda) for a in flanked_inputs(g, n_rows, Wq, L + R + 1))
        seeds = negate_some(seeds)
        kw = dict(L=L, R=R, climb=climb)
        want = sweep_flanked_torch(subs, dd, seeds, io, ie, **kw)
        assert torch.equal(flanked_with(warps, subs, dd, seeds, io, ie, **kw), want)
        planes = seeds.permute(1, 0, 2).contiguous().permute(1, 0, 2)
        assert torch.equal(flanked_with(warps, subs, dd, planes, io, ie, **kw), want)


def fill_scratch_with_noise(n_rows, Wq, F, dev, P=1):
    """Leave noise of any sign where the allocator will put the next launch's
    two scratch buffers (of P sweeps): the kernel computes on what they hold
    outside the field, and none of it may reach a cell of the field."""
    import ctypes
    n_in, n_out = ctypes.c_longlong(), ctypes.c_longlong()
    _build.check(_build.library().tsa_sweep_scratch(n_rows, Wq, F, ctypes.byref(n_in),
                                                    ctypes.byref(n_out)), "scratch")
    noise = [torch.randint(-2**31, 2**31 - 1, (P * n.value,), dtype=torch.int32, device=dev)
             for n in (n_in, n_out)]
    torch.cuda.synchronize()
    del noise


@pytest.mark.cuda
@pytest.mark.parametrize("L,R", [(0, 0), (2, 2)])
@pytest.mark.parametrize("Wq", [1024, 1500])
def test_sweep_kernel_hand_over_between_warps_under_stress_on_card(cuda, Wq, L, R):
    """Many rows through 8 warps, over and over, each time on scratch
    buffers that hold noise: every run equals the plain version (the
    hand-over of the last columns between warps, through shared memory and,
    at 1500 columns, through the scratch rows)."""
    n_rows, F = 1500, L + R + 1
    g = torch.Generator().manual_seed(Wq + F)
    if F == 1:
        args = [a.to(cuda) for a in flankless_inputs(g, n_rows, Wq, negative=True)]
        want = sweep_flankless_torch(*args)
        run = lambda: sweep_flankless(*args)  # noqa: E731
    else:
        subs, dd, seeds, io, ie = (a.to(cuda) for a in flanked_inputs(g, n_rows, Wq, F))
        seeds = negate_some(seeds)
        kw = dict(L=L, R=R, climb=True)
        want = sweep_flanked_torch(subs, dd, seeds, io, ie, **kw)
        run = lambda: sweep_flanked(subs, dd, seeds, io, ie, **kw)  # noqa: E731
    for _ in range(25):
        fill_scratch_with_noise(n_rows, Wq, F, cuda)
        assert torch.equal(run(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 3, 8])
@pytest.mark.parametrize("L,R", [(0, 0), (2, 2)])
def test_sweep_pair_axis_matches_single_launches_on_card(cuda, P, L, R):
    """P sweeps of one shape in one launch, on scratch buffers that hold
    noise, in both seed layouts: each pair equals its own launch and the
    plain version (a pair's lanes read no other pair's scratch rows)."""
    n_rows, Wq, F = 90, 513, L + R + 1
    g = torch.Generator().manual_seed(100 * P + F)
    if F == 1:
        sets = [[a.to(cuda) for a in flankless_inputs(g, n_rows, Wq, negative=True)]
                for _ in range(P)]
        single, kw = sweep_flankless, {}
        plain = sweep_flankless_torch
    else:
        sets = []
        for _ in range(P):
            subs, dd, seeds, io, ie = (a.to(cuda) for a in flanked_inputs(g, n_rows, Wq, F))
            sets.append([subs, dd, negate_some(seeds), io, ie])
        single, kw = sweep_flanked, dict(L=L, R=R, climb=True)
        plain = sweep_flanked_torch
    stacked = [torch.stack(ts) for ts in zip(*sets)]
    # a launch of more than one pair counts as the pair axis's
    name = ("sweep_flankless" if F == 1 else "sweep_flanked") + ("_pairs" if P > 1 else "")
    for layout in ("rows", "planes"):
        if layout == "planes":
            stacked[2] = stacked[2].permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
        for _ in range(3):
            fill_scratch_with_noise(n_rows, Wq, F, cuda, P)
            before = _build.launches[name]
            got = single(*stacked, **kw)
            assert _build.launches[name] == before + 1
            assert got.stride() == stacked[2].stride()
            for z, ts in enumerate(sets):
                want = plain(*ts, **kw)
                assert torch.equal(got[z], want)
                assert torch.equal(single(*ts, **kw), want)


@pytest.mark.cuda
def test_padded_batch_end_to_end_on_card(cuda):
    """The padded_rewind fixture's pairs as one batch on the card: the
    oracle's costs, tracebacks that reprice, every kernel launched."""
    import json
    import os

    from tsalign_tpu_torch.alphabet import get_alphabet
    from tsalign_tpu_torch.config import TemplateSwitchConfig
    from tsalign_tpu_torch.parallel.batch_ts import BatchedTSAligner
    from tsalign_tpu_torch.pricing import price_alignment

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
    al = get_alphabet("dna")
    cfg = TemplateSwitchConfig.parse_plain(
        open(os.path.join(here, "padded_rewind_cfg.tsa")).read(), al)
    pairs = json.load(open(os.path.join(here, "padded_rewind_pairs.json")))["pairs"]
    enc = [(al.encode(r), al.encode(q)) for r, q in pairs]
    _build.launches.clear()
    bt = BatchedTSAligner(cfg, enc, chunk=64, device=cuda)
    traced = bt.align_with_traceback()
    assert [c for c, _ in traced] == [4, 10, 4]
    for (r, q), (c, aln) in zip(enc, traced):
        assert price_alignment(cfg, r, q, aln) == c
    for name in ("sweep_flankless_pairs", "module_scan_pairs", "module_scan_diag"):
        assert _build.launches[name] > 0, name


@pytest.mark.cuda
def test_flanked_sweep_kernel_refuses_too_many_layers(cuda):
    g = torch.Generator().manual_seed(5)
    subs, dd, seeds, io, ie = (a.to(cuda) for a in flanked_inputs(g, 4, 5, 17))
    with pytest.raises(ValueError):
        sweep_flanked(subs, dd, seeds, io, ie, L=8, R=8, climb=True)


def scan_inputs(g, NB, C, W, L, A=6):
    """Seeded module-scan inputs with negative table entries (LUT, io, ie).
    Of every four entry rows one has infinite seeds and one a mask that is
    infinite from a random level on, so the skipping mode leaves problems at
    level 0 and at later levels."""
    # Finite seeds >= L keep every value nonnegative (see ops/common.py).
    seedT = _costs(g, (NB, C, W), L, L + 40, 0.5, 0.05)
    seedT[1::4] = DEV_INF
    lut = _costs(g, (A, C, W), -1, 7, 0.05, 0.05)
    lut[A - 1] = DEV_INF
    sdo = _costs(g, (C, W), 0, 6, 0.05)
    sde = _costs(g, (C, W), 0, 3, 0.05)
    pchar = torch.randint(0, A, (L, NB), generator=g, dtype=torch.int32)
    pmask = torch.where(torch.rand((L, NB), generator=g) < 0.02, DEV_INF, 0).to(torch.int32)
    cut = torch.randint(0, L + 1, (NB,), generator=g)
    dying = torch.arange(L)[:, None] >= cut[None, :]
    dying[:, torch.arange(NB) % 4 != 3] = False
    pmask = torch.where(dying, DEV_INF, pmask).to(torch.int32)
    io = sat_add(_costs(g, (A,), -1, 6)[pchar.long()], pmask)
    ie = sat_add(_costs(g, (A,), -1, 3)[pchar.long()], pmask)
    return seedT, lut, sdo, sde, pchar, pmask, io, ie


# NB = 13 and 16: not a multiple and a multiple of the warps a block.
SCAN_SHAPES = [(16, 8, 5, 12), (16, 8, 201, 12), (16, 8, 1101, 12)] + [
    (13, 4, W, 20) for W in (1, 31, 32, 33, 521, 545, 1100, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("allow_sdel", [True, False])
@pytest.mark.parametrize("fwd", [True, False])
@pytest.mark.parametrize("NB,C,W,L", SCAN_SHAPES)
def test_module_scan_kernel_matches_plain_on_card(cuda, fwd, allow_sdel, NB, C, W, L):
    g = torch.Generator().manual_seed(W + 2 * int(fwd) + int(allow_sdel))
    t = [a.to(cuda) for a in scan_inputs(g, NB, C, W, L)]
    kw = dict(fwd=fwd, allow_sdel=allow_sdel)
    before = _build.launches["module_scan"]
    got = module_scan(*t, **kw)
    assert _build.launches["module_scan"] == before + 1
    assert torch.equal(got, module_scan_torch(*t, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("allow_sdel", [True, False])
@pytest.mark.parametrize("fwd", [True, False])
@pytest.mark.parametrize("NB,C,W,L", SCAN_SHAPES)
def test_module_scan_kernel_skipping_mode_on_card(cuda, fwd, allow_sdel, NB, C, W, L):
    g = torch.Generator().manual_seed(7 * W + 2 * int(fwd) + int(allow_sdel))
    t = [a.to(cuda) for a in scan_inputs(g, NB, C, W, L)]
    _, lut, sdo, _, _, pmask, io, ie = t
    skip_from = dead_state_threshold(lut, sdo, pmask, io, ie, L, allow_sdel=allow_sdel)
    assert skip_from >= DEV_INF_THRESH
    kw = dict(fwd=fwd, allow_sdel=allow_sdel)
    before = _build.launches["module_scan"]
    got = module_scan(*t, **kw, skip_from=skip_from)
    assert _build.launches["module_scan"] == before + 1
    want = module_scan_torch(*t, **kw)
    assert equal_mod_inf(got, want)
    # a problem leaves after the first level whose minimum reaches skip_from:
    # every later entry of its column is exactly DEV_INF
    left = torch.cummax((want >= skip_from).int(), dim=0).values.bool()
    left = torch.cat([torch.zeros_like(left[:1]), left[:-1]])
    assert bool(left.any()) and bool((got[left] == DEV_INF).all())


def widest_module(A, diag=False):
    """The most offsets whose tables fit a block (the kernel's one cap)."""
    lo, hi = 2048, 16384
    while hi - lo > 1:
        mid = (lo + hi) // 2
        try:
            launch_plan(mid, A, diag)
            lo = mid
        except ValueError:
            hi = mid
    return lo


@pytest.mark.cuda
def test_module_scan_kernel_refuses_too_wide_a_module(cuda):
    g = torch.Generator().manual_seed(9)
    W = widest_module(6) + 1
    t = [a.to(cuda) for a in scan_inputs(g, 2, 1, W, 2)]
    with pytest.raises(ValueError):
        module_scan(*t, fwd=True, allow_sdel=True)
    t = [a.to(cuda) for a in scan_inputs(g, 2, 1, 2049, 2)]
    with pytest.raises(ValueError):
        module_scan(*t[:-1], t[-1][:, :1], fwd=True, allow_sdel=True)


# Wide modules: a problem in T = ceil(W / 2048) warps (2, 2, 2 and the most).
WIDE = [2049, 3000, 4096, "widest"]


@pytest.mark.cuda
@pytest.mark.parametrize("allow_sdel", [True, False])
@pytest.mark.parametrize("fwd", [True, False])
@pytest.mark.parametrize("W", WIDE)
def test_module_scan_kernel_wide_modules_on_card(cuda, W, fwd, allow_sdel):
    W = widest_module(6) if W == "widest" else W
    g = torch.Generator().manual_seed(W + 2 * int(fwd) + int(allow_sdel))
    t = [a.to(cuda) for a in scan_inputs(g, 13, 3, W, 9)]
    _, lut, sdo, _, pchar, pmask, io, ie = t
    kw = dict(fwd=fwd, allow_sdel=allow_sdel)
    want = module_scan_torch(*t, **kw)
    before = _build.launches["module_scan_wide"]
    assert torch.equal(module_scan(*t, **kw), want)
    assert _build.launches["module_scan_wide"] == before + 1
    skip_from = dead_state_threshold(lut, sdo, pmask, io, ie, 9, allow_sdel=allow_sdel)
    assert equal_mod_inf(module_scan(*t, **kw, skip_from=skip_from), want)


def diag_inputs(g, NB, W, L, A=6):
    """Seeded inputs of a same-sequence problem (the diagonal mode)."""
    seedT, lut, sdo, sde, pchar, pmask, io, ie = scan_inputs(g, NB, NB, W, L, A)
    return seedT[torch.arange(NB), torch.arange(NB)].contiguous(), lut, sdo, sde, pchar, \
        pmask, io, ie


@pytest.mark.cuda
@pytest.mark.parametrize("allow_sdel", [True, False])
@pytest.mark.parametrize("fwd", [True, False])
@pytest.mark.parametrize("NB,W,L", [(9, 1, 4), (40, 33, 30), (70, 613, 69), (13, 2048, 12),
                                    (11, 2049, 10), (9, 4096, 8)])
def test_module_scan_diag_kernel_matches_plain_on_card(cuda, NB, W, L, fwd, allow_sdel):
    g = torch.Generator().manual_seed(3 * W + 2 * int(fwd) + int(allow_sdel))
    t = [a.to(cuda) for a in diag_inputs(g, NB, W, L)]
    kw = dict(fwd=fwd, allow_sdel=allow_sdel)
    before = _build.launches["module_scan_diag"]
    got = module_scan_diag(*t, **kw)
    assert _build.launches["module_scan_diag"] == before + 1
    assert torch.equal(got, module_scan_torch(*t, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [33, 521, 2049])
def test_module_scan_pair_axis_matches_single_launches_on_card(cuda, W):
    """P problem sets in one launch equal P launches and the plain version,
    in both modes and in the diagonal mode."""
    g = torch.Generator().manual_seed(W)
    sets = [[a.to(cuda) for a in scan_inputs(g, 13, 4, W, 11)] for _ in range(3)]
    stacked = [torch.stack(ts) for ts in zip(*sets)]
    kw = dict(fwd=False, allow_sdel=True)
    before = _build.launches["module_scan_pairs"]
    got = module_scan(*stacked, **kw)
    assert _build.launches["module_scan_pairs"] == before + 1
    for z, ts in enumerate(sets):
        want = module_scan_torch(*ts, **kw)
        assert torch.equal(got[z], module_scan(*ts, **kw)) and torch.equal(got[z], want)
    _, lut, sdo, _, pchar, pmask, io, ie = stacked
    skip_from = dead_state_threshold(lut, sdo, pmask, io, ie, 11, allow_sdel=True)
    got = module_scan(*stacked, **kw, skip_from=skip_from)
    for z, ts in enumerate(sets):
        assert equal_mod_inf(got[z], module_scan_torch(*ts, **kw))
    dsets = [[a.to(cuda) for a in diag_inputs(g, 17, W, 16)] for _ in range(3)]
    got = module_scan_diag(*(torch.stack(ts) for ts in zip(*dsets)), **kw)
    for z, ts in enumerate(dsets):
        assert torch.equal(got[z], module_scan_torch(*ts, **kw))


@pytest.mark.cuda
def test_module_scan_kernel_refuses_a_finite_skip_from(cuda):
    g = torch.Generator().manual_seed(10)
    t = [a.to(cuda) for a in scan_inputs(g, 2, 1, 9, 2)]
    with pytest.raises(ValueError):
        module_scan(*t, fwd=True, allow_sdel=True, skip_from=12345)
