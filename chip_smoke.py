#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card; takes no arguments

Phases, each ending with a line of its wall time (phase_s):
  1. the card (nvidia-smi name and power limit), torch/CUDA versions, and the
     build of the CUDA kernels from tsalign_tpu_torch/csrc;
  2. each kernel against its plain torch version on the card (torch.equal,
     tolerance 0) on seeded inputs holding DEV_INF and DEV_INF - 1, timed
     with CUDA events; the flanked sweep for six (L, R, climb) settings and
     in both seed layouts;
  3. three small planted-TSM pairs under the default configuration and three
     under the flanked default: the port's cost equals the Dijkstra oracle's
     (tsalign_tpu_torch.oracle);
  4. the fixture pairs of tests/fixtures/torch_port_pairs.json (default
     configuration) and torch_port_flanked_pairs.json (flanked default): cost
     and CIGAR equal the JAX package's (recorded on the CPU);
  5. the flankless main path at a real size: a seeded 500 x 420 pair under
     the default configuration through tsalign_tpu_torch.align(...,
     device="cuda"); the flankless sweep and the module scan must launch, and
     the alignment must reprice to the cost; then both kernels against their
     plain versions at the shapes that path launches: the root sweep, and two
     chunks of every cross kind in both directions;
  6. the flanked main path: the same pair with a substitution on either side
     of the planted stretch, under the flanked default (two flank layers on
     either side, F = 5, cheaper flank tables), through
     tsalign_tpu_torch.Aligner(costs=cfg, device="cuda").align(r, q); the
     flanked sweep and the module scan must launch and the flankless sweep
     must not, the alignment must reprice to the cost (with its flank labels
     restored, see `with_flank_labels`) and hold a flank operation; then the flanked sweep against its plain version at that
     path's shapes (the root seeds and a later round's seeds).
Any failure raises, so the script exits nonzero before its last line.  The
last lines are the kernels' JSON record, the card's name and power limit,
and {"ok": true, "device": {...}}.

In the kernels' record, bound_ms is the least time the card could take for
the compared call: the larger of its bytes (every input read once, the
output written once) over 3.35 TB/s and its integer operations over
16.75e12 a second.  That integer rate is the H100's float32 peak outside
the tensor cores (67 TFLOP/s: 132 SMs x 128 lanes x 2 operations a fused
multiply-add) cut to the 64 int32 lanes an SM has, each doing one
operation a clock.  library_ms is null: no single PyTorch call computes a (min,+)
wavefront or the module scan.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# Python puts this script's directory first on sys.path, so the package
# imports from the checkout it sits in (and fails where it sits alone).
import tsalign_tpu_torch
from tsalign_tpu_torch import _build
from tsalign_tpu_torch.alignment import Alignment, TemplateSwitchEntrance, TemplateSwitchExit
from tsalign_tpu_torch.alphabet import get_alphabet
from tsalign_tpu_torch.config import TemplateSwitchConfig
from tsalign_tpu_torch.costs import GapAffineCostTable
from tsalign_tpu_torch.engine import TorchAligner, next_seeds
from tsalign_tpu_torch.ops.common import DEV_INF, sat_add
from tsalign_tpu_torch.ops.module_scan import module_scan
from tsalign_tpu_torch.ops.modules import module_scan_torch
from tsalign_tpu_torch.ops.sweep import (sweep_flanked, sweep_flanked_torch, sweep_flankless,
                                         sweep_flankless_torch)
from tsalign_tpu_torch.oracle import OracleAligner
from tsalign_tpu_torch.pricing import price_alignment

DEV = "cuda"
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures")
FIXTURE = os.path.join(FIXTURES, "torch_port_pairs.json")
FLANKED_FIXTURE = os.path.join(FIXTURES, "torch_port_flanked_pairs.json")
# (name, seed, reference length, planted reverse-complement length, SNPs) of
# the flanked fixture's pairs; each also gets the two flank substitutions.
FLANKED_FIXTURE_PAIRS = (("flanked_60", 1060, 60, 12, 2), ("flanked_90", 1090, 90, 16, 2),
                         ("flanked_120", 1120, 120, 20, 3))
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
KERNELS = {
    "sweep_flankless": {
        "route": "cuda",
        "source": "tsalign_tpu_torch/csrc/sweep_flankless.cu",
        "replaces": "tsalign_tpu/ops/pallas_sweep.py:238",
    },
    "sweep_flanked": {
        "route": "cuda",
        "source": "tsalign_tpu_torch/csrc/sweep_flanked.cu",
        "replaces": "tsalign_tpu/ops/pallas_sweep.py:392",
    },
    "module_scan": {
        "route": "cuda",
        "source": "tsalign_tpu_torch/csrc/module_scan.cu",
        "replaces": "tsalign_tpu/ops/pallas_module.py:142",
    },
}
max_err = {name: None for name in KERNELS}


def say(phase, **numbers):
    print(f"[phase {phase}] " + json.dumps(numbers), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` runs after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def under_load(fn):
    """fn() while nvidia-smi samples the card every 100 ms; returns fn's
    result and the SM clock (MHz, least and median), power draw (W, most) and
    temperature (C, most) over the samples.  Two cards of one name and power
    limit can run a throughput-bound kernel at different clocks."""
    sampler = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        sampler.terminate()
        lines = sampler.communicate()[0].strip().splitlines()
    rows = [[float(x) for x in line.split(",")] for line in lines if line.count(",") == 2]
    if not rows:
        return out, {}
    mhz = sorted(r[0] for r in rows)
    return out, dict(samples=len(rows), sm_mhz_min=mhz[0], sm_mhz_median=mhz[len(mhz) // 2],
                     power_w_max=max(r[1] for r in rows), temp_c_max=max(r[2] for r in rows))


def compare(name, got, want, what):
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name} {what}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    max_err[name] = max(max_err[name] or 0, err)
    if not torch.equal(got, want):
        raise AssertionError(f"{name} {what}: kernel differs from the plain version (max abs err {err})")


def rand_costs(gen, shape, lo, hi, p_inf=0.0, p_inf1=0.0):
    """Seeded int32 costs in [lo, hi) with DEV_INF / DEV_INF - 1 entries."""
    x = torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)
    u = torch.rand(shape, generator=gen)
    x[u < p_inf] = DEV_INF
    x[(u >= p_inf) & (u < p_inf + p_inf1)] = DEV_INF - 1
    return x.to(DEV)


def sweep_inputs(gen, n_rows, Wq):
    sub = rand_costs(gen, (n_rows, Wq), 0, 7, 0.02, 0.02)
    sub[0] = DEV_INF
    dd = rand_costs(gen, (n_rows, 2), 0, 6, 0.02)
    seeds = rand_costs(gen, (n_rows, 3, Wq), 0, 60, 0.9, 0.05)
    io = rand_costs(gen, (Wq,), 0, 6, 0.02)
    ie = rand_costs(gen, (Wq,), 0, 3, 0.02)
    return sub, dd, seeds, io, ie


def flanked_sweep_inputs(gen, n_rows, Wq, F):
    subs = rand_costs(gen, (3, n_rows, Wq), 0, 7, 0.02, 0.02)
    subs[:, 0] = DEV_INF
    dd = rand_costs(gen, (n_rows, 6), 0, 6, 0.02)
    seeds = rand_costs(gen, (n_rows, 3 * F, Wq), 0, 60, 0.9, 0.05)
    io = rand_costs(gen, (3, Wq), 0, 6, 0.02)
    ie = rand_costs(gen, (3, Wq), 0, 3, 0.02)
    return subs, dd, seeds, io, ie


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, n_ops: int):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    integer operations over the int32 rate (see the module docstring)."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / INT32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


# Integer operations (add or min) a cell needs, counted from the recurrences:
# none 5 (min3, add, clamp, min with the seed), del 7 (open min, two clamped
# adds, two mins, the seed), ins 7 (open min, clamped add, seed min, the
# chain's add, clamp and min).  A climbing flank layer takes the same 5 + 7
# for none and del and 7 for its one-step insertion.
SWEEP_OPS_PER_CELL = 19
# Module scan, per (entry row, column, offset) and level: close 6 (open min,
# clamped add, the chain's add, clamp and min) when secondary deletions are
# on, emit 3, step 12 (LUT add and clamp, min3, the insertion's six, the
# diagonal's clamped add).
SCAN_CLOSE_OPS, SCAN_EMIT_OPS, SCAN_STEP_OPS = 6, 3, 12


def sweep_flankless_bound(sub_rows, dd, seeds, io, ie):
    cells = sub_rows.shape[0] * sub_rows.shape[1]
    return bound(nbytes(sub_rows, dd, seeds, io, ie) + nbytes(seeds),
                 cells * SWEEP_OPS_PER_CELL)


def sweep_flanked_bound(subs, dd, seeds, io, ie, *, L, R, climb):
    cells = subs.shape[1] * subs.shape[2]
    climbing = R + (L if climb else 0)
    return bound(nbytes(subs, dd, seeds, io, ie) + nbytes(seeds),
                 cells * SWEEP_OPS_PER_CELL * (1 + climbing))


def module_scan_bound(seedT, lut, sdo, sde, pchar, pmask, io, ie, *, allow_sdel):
    NB, C, W = seedT.shape
    L = pchar.shape[0]
    close_emit = (SCAN_CLOSE_OPS if allow_sdel else 0) + SCAN_EMIT_OPS
    ops = NB * C * W * (L * (close_emit + SCAN_STEP_OPS) + close_emit)
    out_bytes = 4 * (L + 1) * NB * C
    return bound(nbytes(seedT, lut, sdo, sde, pchar, pmask, io, ie) + out_bytes, ops)


def module_inputs(gen, NB, C, W, L, A=6):
    # Finite seeds >= L keep every value nonnegative (see ops/common.py).
    seedT = rand_costs(gen, (NB, C, W), L, L + 40, 0.5, 0.05)
    lut = rand_costs(gen, (A, C, W), -1, 7, 0.05, 0.05)
    lut[A - 1] = DEV_INF
    sdo = rand_costs(gen, (C, W), 0, 6, 0.05)
    sde = rand_costs(gen, (C, W), 0, 3, 0.05)
    pchar = torch.randint(0, A, (L, NB), generator=gen, dtype=torch.int32).to(DEV)
    pmask = torch.where(torch.rand((L, NB), generator=gen) < 0.1, DEV_INF, 0).to(torch.int32).to(DEV)
    pgo = rand_costs(gen, (A,), -1, 6)
    pge = rand_costs(gen, (A,), -1, 3)
    io = sat_add(pgo[pchar.long()], pmask)
    ie = sat_add(pge[pchar.long()], pmask)
    return seedT, lut, sdo, sde, pchar, pmask, io, ie


def phase1():
    t0 = time.monotonic()
    _build.library()
    say(1, card=card_line(), torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], build_s=time.monotonic() - t0,
        devices=torch.cuda.device_count())


def phase2():
    gen = torch.Generator().manual_seed(2)
    for n_rows, Wq in ((17, 1), (40, 33), (1001, 1001), (300, 2100)):
        args = sweep_inputs(gen, n_rows, Wq)
        compare("sweep_flankless", sweep_flankless(*args), sweep_flankless_torch(*args),
                f"n_rows={n_rows} Wq={Wq}")
        say(2, kernel="sweep_flankless", n_rows=n_rows, Wq=Wq, equal=True,
            ms=cuda_ms(lambda: sweep_flankless(*args), 10),
            plain_ms=cuda_ms(lambda: sweep_flankless_torch(*args), 1))
    for L, R, climb in ((0, 1, True), (1, 0, True), (1, 0, False), (2, 2, True),
                        (2, 2, False), (5, 5, True)):
        for n_rows, Wq in ((17, 1), (40, 33), (120, 513), (60, 2100)):
            subs, dd, seeds, io, ie = flanked_sweep_inputs(gen, n_rows, Wq, L + R + 1)
            kw = dict(L=L, R=R, climb=climb)
            want = sweep_flanked_torch(subs, dd, seeds, io, ie, **kw)
            what = f"L={L} R={R} climb={climb} n_rows={n_rows} Wq={Wq}"
            compare("sweep_flanked", sweep_flanked(subs, dd, seeds, io, ie, **kw), want, what)
            # the engine's plane-major layout, read and written in place
            planes = seeds.permute(1, 0, 2).contiguous().permute(1, 0, 2)
            got = sweep_flanked(subs, dd, planes, io, ie, **kw)
            if got.stride() != planes.stride():
                raise AssertionError(f"sweep_flanked {what}: plane-major seeds gave another layout")
            compare("sweep_flanked", got.contiguous(), want, what + " plane-major")
            say(2, kernel="sweep_flanked", L=L, R=R, climb=climb, n_rows=n_rows, Wq=Wq,
                equal=True,
                ms=cuda_ms(lambda: sweep_flanked(subs, dd, seeds, io, ie, **kw), 10),
                plain_ms=cuda_ms(lambda: sweep_flanked_torch(subs, dd, seeds, io, ie, **kw), 1))
    for fwd in (True, False):
        for sdel in (True, False):
            for C in (8, 64):
                for L in (5, 64):
                    args = module_inputs(gen, 64, C, 201, L)
                    got = module_scan(*args, fwd=fwd, allow_sdel=sdel)
                    want = module_scan_torch(*args, fwd=fwd, allow_sdel=sdel)
                    compare("module_scan", got, want, f"fwd={fwd} sdel={sdel} C={C} L={L}")
                    kw = dict(fwd=fwd, allow_sdel=sdel)
                    say(2, kernel="module_scan", NB=64, C=C, W=201, L=L, fwd=fwd,
                        allow_sdel=sdel, equal=True,
                        ms=cuda_ms(lambda: module_scan(*args, **kw), 10),
                        plain_ms=cuda_ms(lambda: module_scan_torch(*args, **kw), 1))


def planted_pair(rng, n, ts_len, snps, indel, q_len=None, flank_snps=False):
    """Random reference; the query copies its first `q_len` bases (all by
    default) with `snps` substitutions, an optional 1-bp deletion, and one
    planted reverse-complement stretch; with `flank_snps` also a substitution
    in the base before that stretch and in the base after it."""
    al = get_alphabet("dna")
    ref = rng.integers(0, 4, size=n).astype(np.int8)
    qry = list(ref)
    for _ in range(snps):
        k = int(rng.integers(0, n))
        qry[k] = (qry[k] + int(rng.integers(1, 4))) % 4
    a = int(rng.integers(4, (q_len or n) - ts_len - 4))
    comp = al.complement_array()
    qry[a : a + ts_len] = [int(comp[c]) for c in qry[a : a + ts_len]][::-1]
    if flank_snps:
        for k in (a - 1, a + ts_len):
            qry[k] = (qry[k] + 1) % 4
    if indel:
        del qry[int(rng.integers(0, len(qry)))]
    qry = qry[:q_len]
    return al.decode(ref), al.decode(np.array(qry, dtype=np.int8))


def flanked_default(al) -> TemplateSwitchConfig:
    """The default configuration with two flank layers on either side
    (F = 5) and flank tables cheaper than the primary one (match 0,
    substitution 1, gap open 2, gap extend 1 against 0 / 2 / 3 / 1), so that
    the flank layers change the optimum."""
    cfg = TemplateSwitchConfig.default(al)
    cfg.left_flank_length = cfg.right_flank_length = 2
    cfg.left_flank_edit_costs = GapAffineCostTable.base_agnostic(
        "Left Flank Edit Costs", al, 0, 1, 2, 1)
    cfg.right_flank_edit_costs = GapAffineCostTable.base_agnostic(
        "Right Flank Edit Costs", al, 0, 1, 2, 1)
    return cfg


def with_flank_labels(alignment, L, R, trailing):
    """The alignment one operation an entry, with the flank labels restored.

    The record's run-length merge rule puts a flank operation and the
    primary operation of the same kind into one run under one label, so a
    record of a flanked config does not reprice as it stands.  The model
    fixes where the flank operations are: the R operations after a
    template-switch exit (flank -R up to 0), the L operations before an
    entrance (flank 0 up to L), and `trailing` (at most L) operations at the
    very end, since the target accepts any flank layer."""
    ops = []
    for n, t in alignment.entries:
        if isinstance(t, str):
            ops += [t.replace("PrimaryFlank", "Primary")] * n
        else:
            ops.append(t)

    def relabel(indices, count):
        for k in indices:
            t = ops[k]
            if (count == 0 or not isinstance(t, str) or not t.startswith("Primary")
                    or t.startswith("PrimaryFlank")):
                return
            ops[k] = ops[k].replace("Primary", "PrimaryFlank")
            count -= 1

    for k, t in enumerate(list(ops)):
        if isinstance(t, TemplateSwitchExit):
            relabel(range(k + 1, len(ops)), R)
    for k, t in enumerate(list(ops)):
        if isinstance(t, TemplateSwitchEntrance):
            relabel(range(k - 1, -1, -1), L)
    relabel(range(len(ops) - 1, -1, -1), trailing)
    return Alignment([(1, t) for t in ops])


def reprice(cfg, ref, qry, alignment):
    """(cost, flank operations) of a recorded alignment under `cfg`, priced
    by ``pricing.price_alignment`` after `with_flank_labels`.  The record does
    not say how many flank operations end the path, so the least price over
    the possible counts is taken: each count gives a path of the model or no
    path, and no path of the model is cheaper than the optimum (of an
    alignment made under no limit on the template switches: a limit forbids
    the left-flank climb in the last round, which the pricing does not know)."""
    L, R = cfg.left_flank_length, cfg.right_flank_length
    best = None
    for trailing in range(L + 1):
        labelled = with_flank_labels(alignment, L, R, trailing)
        price = price_alignment(cfg, ref, qry, labelled)
        flank_ops = sum(1 for _, t in labelled.entries
                        if isinstance(t, str) and t.startswith("PrimaryFlank"))
        if best is None or price < best[0]:
            best = (price, flank_ops)
    return best


def phase3():
    al = get_alphabet("dna-n")
    for flanked in (False, True):
        cfg = flanked_default(al) if flanked else TemplateSwitchConfig.default(al)
        for seed in range(3):
            rng = np.random.default_rng((330 if flanked else 300) + seed)
            n = int(rng.integers(40, 61))
            r, q = planted_pair(rng, n, int(rng.integers(8, 13)), 2, seed == 1,
                                flank_snps=flanked)
            got = tsalign_tpu_torch.Aligner(costs=cfg, device=DEV).align(r, q)
            want, _ = OracleAligner(cfg, al.encode(r), al.encode(q)).align()
            if got.stats()["cost"] != want:
                raise AssertionError(
                    f"pair {seed} flanked={flanked}: port cost {got.stats()['cost']} "
                    f"!= oracle {want}")
            say(3, pair=seed, flanked=flanked, n_r=len(r), n_q=len(q), cost=want, equal=True)


def phase4():
    al = get_alphabet("dna-n")
    for path, cfg in ((FIXTURE, TemplateSwitchConfig.default(al)),
                      (FLANKED_FIXTURE, flanked_default(al))):
        with open(path) as f:
            fixture = json.load(f)
        for p in fixture["pairs"]:
            got = tsalign_tpu_torch.Aligner(costs=cfg, device=DEV).align(
                p["reference"], p["query"])
            if got.stats()["cost"] != p["cost"] or got.cigar() != p["cigar"]:
                raise AssertionError(
                    f"fixture {p['name']}: port {got.stats()['cost']} {got.cigar()} "
                    f"!= JAX {p['cost']} {p['cigar']}"
                )
            say(4, pair=p["name"], n_r=len(p["reference"]), n_q=len(p["query"]),
                cost=p["cost"], equal=True)


def phase5():
    # 500 x 420 (the heli scale), not 1000 x 1000: see PERF.md, section 4,
    # for the measured times that rule the larger pair out of the 1200 s run.
    rng = np.random.default_rng(500)
    r, q = planted_pair(rng, 500, 40, 5, True, q_len=420)
    al = get_alphabet("dna-n")
    cfg = TemplateSwitchConfig.default(al)
    _build.launches.clear()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    res = tsalign_tpu_torch.align(r, q, device=DEV)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = dict(_build.launches)
    cost = res.stats()["cost"]
    priced = price_alignment(cfg, al.encode(r), al.encode(q), res.result.alignment)
    if priced != cost:
        raise AssertionError(f"main pair: alignment reprices to {priced}, reported {cost}")
    for name in ("sweep_flankless", "module_scan"):
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"main pair: kernel {name} was not launched")
    if counts.get("sweep_flanked", 0) != 0:
        raise AssertionError("main pair: a flankless config launched the flanked sweep")
    cells = res.stats()["opened_nodes"]
    say(5, n_r=len(r), n_q=len(q), cost=cost, repriced=priced,
        ts=res.stats()["template_switch_amount"], wall_s=wall,
        cells=cells, cells_per_s=cells / wall, launches=counts)
    return r, q, counts


def phase5_shapes(r, q):
    """Both kernels against their plain versions at the main path's shapes
    in its first reentry round: the root sweep, and for every active cross
    kind (forward and reverse, each with its own allow_sdel) the chunk at
    entry column 0 and the middle live chunk after it.  Returns the kernel
    and plain times of the root sweep and of the first kind's chunk 0."""
    al = get_alphabet("dna-n")
    n = len(r) + len(q) + 2
    K = 1
    while K < n:
        K *= 2
    cfg = TemplateSwitchConfig.default(al).scaled_for_length_tiebreak(K)
    eng = TorchAligner(cfg, al.encode(r), al.encode(q), device=DEV)
    root = eng._root_seeds()
    sub_rows, dd, io, ie = eng._get_sweep(True)._inputs_on(root.device)
    seeds = root[0].permute(1, 0, 2).contiguous()
    args = (sub_rows, dd, seeds, io, ie)
    compare("sweep_flankless", sweep_flankless(*args), sweep_flankless_torch(*args), "main shapes")
    timings = {"sweep_flankless": (cuda_ms(lambda: sweep_flankless(*args), 20),
                                   cuda_ms(lambda: sweep_flankless_torch(*args), 1),
                                   *sweep_flankless_bound(*args))}
    say(5, kernel="sweep_flankless", shape=list(seeds.shape), equal=True,
        ms=timings["sweep_flankless"][0], plain_ms=timings["sweep_flankless"][1],
        bound_ms=timings["sweep_flankless"][2], bound_by=timings["sweep_flankless"][3])

    E, best, _ = eng._sweep_summary(root, True)
    A = eng._pruned_entry_cells(E, best)
    AS = eng._entry_bound(A, best)
    kinds = [km for km in eng._build_kinds(eng._sdel_budget(best)) if not km.same_seq]
    if {km.dk for km in kinds} != {0, 1}:
        raise AssertionError(f"main pair: cross kinds of one direction only: {[km.dk for km in kinds]}")
    for km in kinds:
        A_np = A if km.spec.pk == 0 else A.T
        A_mod = torch.from_numpy(np.ascontiguousarray(A_np)).to(DEV)
        t = km.tables(DEV)
        C = km.chunk
        later = [b for b in eng._chunk_bases(km, A_np, AS, best) if b > 0]
        if not later:  # no live chunk after column 0: take the middle one
            n_e = km.spec.n_anti + 1
            later = [min(e0, n_e - C) for e0 in range(C, n_e, C)]
        for e_base in [0] + later[len(later) // 2 :][:1]:
            sl = slice(e_base, e_base + C)
            seedT = sat_add(A_mod[:, sl][:, :, None], t["seed"][sl][None, :, :]).contiguous()
            margs = (seedT, t["lut"][:, sl].contiguous(), t["sdo"][sl].contiguous(),
                     t["sde"][sl].contiguous(), t["pchar_l"], t["pmask_l"], t["io_l"], t["ie_l"])
            kw = dict(fwd=km.dk == 0, allow_sdel=km.allow_sdel)
            got = module_scan(*margs, **kw)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            want = module_scan_torch(*margs, **kw)
            torch.cuda.synchronize()
            plain_ms = (time.monotonic() - t0) * 1e3
            kind = [km.spec.pk, km.spec.sk, km.dk]
            compare("module_scan", got, want, f"kind {kind} chunk {e_base}")
            if "module_scan" not in timings:  # the reported time, with the card's clocks
                ms, card = under_load(lambda: cuda_ms(lambda: module_scan(*margs, **kw), 20))
                say(5, kernel="module_scan", card_under_load=card)
            else:
                ms = cuda_ms(lambda: module_scan(*margs, **kw), 3)
            bound_ms, bound_by = module_scan_bound(*margs, allow_sdel=km.allow_sdel)
            timings.setdefault("module_scan", (ms, plain_ms, bound_ms, bound_by))
            NB, Cc, W = seedT.shape
            say(5, kernel="module_scan", kind=kind, e_base=e_base, NB=NB, C=Cc, W=W,
                L=km.L, fwd=kw["fwd"], allow_sdel=km.allow_sdel, equal=True,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    return timings


def phase6():
    """The flanked main path: the main pair with its two flank substitutions
    under the flanked default, through the facade on the card."""
    rng = np.random.default_rng(500)
    r, q = planted_pair(rng, 500, 40, 5, True, q_len=420, flank_snps=True)
    al = get_alphabet("dna-n")
    cfg = flanked_default(al)
    _build.launches.clear()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    aligner = tsalign_tpu_torch.Aligner(costs=cfg, device=DEV)
    res = aligner.align(r, q)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = dict(_build.launches)
    cost = res.stats()["cost"]
    priced, flank_ops = reprice(cfg, al.encode(r), al.encode(q), res.result.alignment)
    if priced != cost:
        raise AssertionError(f"flanked main pair: alignment reprices to {priced}, reported {cost}")
    for name in ("sweep_flanked", "module_scan"):
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"flanked main pair: kernel {name} was not launched")
    if counts.get("sweep_flankless", 0) != 0:
        raise AssertionError("flanked main pair: a flanked config launched the flankless sweep")
    recorded = sum(n for n, t in res.result.alignment.entries
                   if isinstance(t, str) and t.startswith("PrimaryFlank"))
    if flank_ops <= 0 or recorded <= 0:
        raise AssertionError(f"flanked main pair: no flank operation in {res.cigar()}")
    cells = res.stats()["opened_nodes"]
    say(6, n_r=len(r), n_q=len(q), cost=cost, repriced=priced, flank_ops=flank_ops,
        ts=res.stats()["template_switch_amount"], wall_s=wall, cells=cells,
        cells_per_s=cells / wall, rounds_last_pass=aligner._last_rounds, launches=counts)
    return r, q, counts


def phase6_shapes(r, q):
    """The flanked sweep against its plain version at the flanked main
    path's shapes, in the engine's plane-major layout: from the root seeds
    and from the seeds of the round after the first reentry (climb on).
    Returns the times and the bound of the second."""
    al = get_alphabet("dna-n")
    n = len(r) + len(q) + 2
    K = 1
    while K < n:
        K *= 2
    cfg = flanked_default(al).scaled_for_length_tiebreak(K)
    eng = TorchAligner(cfg, al.encode(r), al.encode(q), device=DEV)
    sweep = eng._get_sweep(True)
    subs, dd, io, ie = sweep._inputs_on(torch.device(DEV))
    kw = dict(L=sweep.L, R=sweep.R, climb=True)
    root = eng._root_seeds()
    E, best, _ = eng._sweep_summary(root, True)
    kinds = eng._build_kinds(eng._sdel_budget(best))
    R = eng._reentry(eng._pruned_entry_cells(E, best), kinds, best=best)
    out = None
    for what, seeds4 in (("root seeds", root), ("round 1 seeds", next_seeds(root, R))):
        F, _, n_rows, Wq = seeds4.shape
        seeds = seeds4.view(3 * F, n_rows, Wq).permute(1, 0, 2)
        args = (subs, dd, seeds, io, ie)
        compare("sweep_flanked", sweep_flanked(*args, **kw), sweep_flanked_torch(*args, **kw),
                f"flanked main shapes, {what}")
        ms = cuda_ms(lambda: sweep_flanked(*args, **kw), 20)
        plain_ms = cuda_ms(lambda: sweep_flanked_torch(*args, **kw), 1)
        bound_ms, bound_by = sweep_flanked_bound(*args, **kw)
        seeded = int((seeds4 < DEV_INF).sum())
        say(6, kernel="sweep_flanked", seeds=what, shape=list(seeds.shape), finite_seeds=seeded,
            equal=True, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        out = (ms, plain_ms, bound_ms, bound_by)
    return {"sweep_flanked": out}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)")
    for phase, fn in ((1, phase1), (2, phase2), (3, phase3), (4, phase4)):
        t0 = time.monotonic()
        fn()
        say(phase, phase_s=time.monotonic() - t0)
    t0 = time.monotonic()
    r, q, counts = phase5()
    timings = phase5_shapes(r, q)
    say(5, phase_s=time.monotonic() - t0)
    t0 = time.monotonic()
    r, q, flanked_counts = phase6()
    timings.update(phase6_shapes(r, q))
    say(6, phase_s=time.monotonic() - t0)
    kernels = []
    for name, meta in KERNELS.items():
        if max_err[name] is None or name not in timings:
            raise AssertionError(f"{name}: not compared or not timed at the main shapes")
        ms, plain_ms, bound_ms, bound_by = timings[name]
        by_path = {"flankless": counts.get(name, 0), "flanked": flanked_counts.get(name, 0)}
        # the launches of the newest main path that runs the kernel
        launches = by_path["flanked"] or by_path["flankless"]
        if launches <= 0:
            raise AssertionError(f"{name}: launched on no main path")
        kernels.append(dict(name=name, **meta, launches=launches, launches_by_path=by_path,
                            max_abs_err=max_err[name], ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
