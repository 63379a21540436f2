"""The frozen byte and operation counts equal the originals they were copied
from (chip_smoke.py's bound, module_scan_work and assembly_bound,
tests/torch_cases.py's assembly_bytes) at a main-path shape: the 200-bp
pair's kinds at the engine's chunk of 64."""

import os
import sys

import pytest
import torch

from harness import cells, roofline, traffic
import small

sys.path.insert(0, os.path.join(cells.ROOT, "tests"))


@pytest.fixture(scope="module")
def originals():
    import chip_smoke
    import torch_cases

    return chip_smoke, torch_cases


@pytest.fixture(scope="module")
def kinds(originals):
    from tsalign_tpu_torch.alphabet import get_alphabet
    from tsalign_tpu_torch.config import TemplateSwitchConfig

    _, torch_cases = originals
    al = get_alphabet("dna-n")
    t = small.traffic("twin160-ts")
    ref, qry = traffic.twin(traffic.stream(2**31 + 5, traffic.WINDOW), t)
    return torch_cases.assembly_kinds(TemplateSwitchConfig.default(al), al.encode(ref),
                                      al.encode(qry), 64)


def test_peaks_and_bound(originals):
    chip_smoke, _ = originals
    assert roofline.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert roofline.INT32_OPS_PER_S == chip_smoke.INT32_OPS_PER_S
    for n_bytes, n_ops in ((6_500_000, 10_000), (1_000, 7e10), (0, 0)):
        ms, _ = chip_smoke.bound(n_bytes, n_ops)
        assert roofline.least_seconds(n_bytes, n_ops) * 1e3 == pytest.approx(ms, rel=1e-12)


def test_assembly_counts(originals, kinds):
    chip_smoke, torch_cases = originals
    gen = torch.Generator().manual_seed(3)
    for km in kinds:
        n_rows, C = km.n_p + 1, km.chunk
        span = C + km.S - 1
        assert roofline.assembly_bytes(km, n_rows, C, span) == torch_cases.assembly_bytes(
            km, n_rows, C, span)
        _, A = torch_cases.assembly_inputs(gen, km, "cpu")
        n_bytes, ops = roofline.assembly_work([A], [km], [span])
        ms, _ = chip_smoke.assembly_bound([A], [km], [span])
        assert roofline.least_seconds(n_bytes, ops) * 1e3 == pytest.approx(ms, rel=1e-12)


@pytest.mark.parametrize("skip", [False, True])
def test_module_scan_counts(originals, skip):
    chip_smoke, torch_cases = originals
    from tsalign_tpu_torch.ops.common import dead_state_threshold
    from tsalign_tpu_torch.ops.modules import module_scan_torch

    gen = torch.Generator().manual_seed(11)
    NB, C, W, L, A = 40, 8, 23, 12, 6
    rc = torch_cases.rand_costs
    seedT = rc(gen, (NB, C, W), L, L + 40, 0.5, 0.05)
    seedT[1::4] = 2**30 - 1  # DEV_INF: dead at level 0
    lut = rc(gen, (A, C, W), 0, 7, 0.05, 0.05)
    sdo, sde = rc(gen, (C, W), 0, 6, 0.05), rc(gen, (C, W), 0, 3, 0.05)
    pchar = torch.randint(0, A, (L, NB), generator=gen, dtype=torch.int32)
    pmask = torch.where(torch.rand((L, NB), generator=gen) < 0.1, 2**30 - 1, 0).to(torch.int32)
    io, ie = rc(gen, (L, NB), 0, 6), rc(gen, (L, NB), 0, 3)
    args = (seedT, lut, sdo, sde, pchar, pmask, io, ie)
    B = module_scan_torch(*args, fwd=True, allow_sdel=True)
    skip_from = dead_state_threshold(lut, sdo, pmask, io, ie, L, allow_sdel=True) if skip else 0
    if skip:
        # the kernel's skipping mode leaves a problem at its first dead level
        dead = B >= skip_from
        first = torch.where(dead.any(0), dead.int().argmax(0), L)
        B_kernel = torch.where(torch.arange(L + 1)[:, None, None] > first, 2**30 - 1, B)
    else:
        B_kernel = B
    n_bytes, ops = roofline.module_scan_work(args, B_kernel, allow_sdel=True,
                                             skip_from=skip_from, diag=False)
    want_bytes, want_ops, *_ = chip_smoke.module_scan_work(
        *args, allow_sdel=True, B_plain=B if skip else None, skip_from=skip_from)
    assert (n_bytes, int(ops)) == (want_bytes, want_ops)
    ms, _ = chip_smoke.bound(want_bytes, want_ops)
    assert float(roofline.least_seconds(n_bytes, ops)) * 1e3 == pytest.approx(ms, rel=1e-6)
