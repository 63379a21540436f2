#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card; takes no arguments

Phases, each ending with a line of its wall time (phase_s):
  1. the card (nvidia-smi name and power limit), torch/CUDA versions, the
     build of the CUDA kernels from tsalign_tpu_torch/csrc, what ptxas
     and cuobjdump say of the module scan (registers and spills of every
     instantiation, DPX instructions in its SASS) and ptxas of the sweep's
     instantiations, and the latency of one dependent DPX instruction (a
     one-thread loop in csrc/sweep.cu) with the SM clock it ran at;
  2. each kernel against its plain torch version on the card (torch.equal,
     tolerance 0) on seeded inputs holding DEV_INF and DEV_INF - 1, timed
     with CUDA events; the sweeps in both seed layouts, the flanked one for
     six (L, R, climb) settings, and both at the edges of a super-tile and of
     a block's eight, with the launch's warps and with fewer, on negative
     seeds beside infinite ones, and many rows over and over on scratch
     buffers that hold noise; the module scan in both of its modes (the exact
     mode by torch.equal, the skipping mode by equal_mod_inf: equal below
     2^29, infinite where the plain version is) on inputs a part of whose
     problems die (infinite seed rows, a mask that turns infinite);
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
     chunks of every cross kind in both directions, the module scan in both
     modes with each mode's time and bound, the share of (problem, level)
     pairs the skipping mode has to run and the share of problems dead at
     level 0;
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
output written once) over 3.35 TB/s and its integer min/add operations over
33.5e12 a second.  For the sweeps a third time is taken beside the two, the
dependency chain: cell (row, layer, column) needs its left neighbour, so the
longest path runs through n_rows + Wq + F - 2 cells, each two dependent
integer instructions (the chain's clamped add and min in one DPX instruction,
and the open's), at the latency phase 1 measured; no wavefront of one pair
can run faster, and bound_by then reads "chain".  The module scan's skipping mode counts the levels its
inputs need: for each problem those up to the first whose exit minimum in the
plain result reaches skip_from (the kernel's own criterion).  That integer
rate is the H100's float32 peak outside the tensor cores (67 TFLOP/s: 132 SMs
x 128 lanes x 2 operations a fused multiply-add) cut to the 64 int32 lanes an
SM has, each taking one instruction a clock, times the two operations a DPX
instruction does (an add and a min in VIADDMNMX, two mins in VIMNMX3).  Before
the module scan used DPX the bound took one operation an instruction
(16.75e12 a second); the kernel now runs below that figure, so it was no
bound.  library_ms is null: no single PyTorch call computes a (min,+)
wavefront or the module scan.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
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
from tsalign_tpu_torch.ops.common import (DEV_INF, DEV_INF_THRESH, dead_state_threshold,
                                          equal_mod_inf, sat_add)
from tsalign_tpu_torch.ops.module_scan import module_scan
from tsalign_tpu_torch.ops.modules import module_scan_torch
from tsalign_tpu_torch.ops import sweep as sweep_ops
from tsalign_tpu_torch.ops.sweep import (dpx_chain_clocks, sweep_flanked, sweep_flanked_torch,
                                         sweep_flankless, sweep_flankless_torch)
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
INT32_OPS_PER_S = 67e12 / 4 * 2  # 64 of an SM's 128 lanes, two operations a DPX instruction
KERNELS = {
    "sweep_flankless": {
        "route": "cuda",
        "source": "tsalign_tpu_torch/csrc/sweep.cu",
        "replaces": "tsalign_tpu/ops/pallas_sweep.py:238",
    },
    "sweep_flanked": {
        "route": "cuda",
        "source": "tsalign_tpu_torch/csrc/sweep.cu",
        "replaces": "tsalign_tpu/ops/pallas_sweep.py:392",
    },
    "module_scan": {
        "route": "cuda",
        "source": "tsalign_tpu_torch/csrc/module_scan.cu",
        "replaces": "tsalign_tpu/ops/pallas_module.py:142",
    },
}
max_err = {name: None for name in KERNELS}
# Nanoseconds of one dependent DPX instruction; phase 1 measures it.
dpx_ns = {"clocks": None, "sm_mhz": None, "ns": None}


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


def compare(name, got, want, what, mod_inf=False):
    """Raise unless the kernel's `got` equals the plain version's `want`:
    by torch.equal, or with `mod_inf` by equal_mod_inf (the error is then
    taken over the entries where `want` is below 2^29)."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name} {what}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    diff = (got.long() - want.long()).abs()
    if mod_inf:
        diff = diff[want < DEV_INF_THRESH]
    err = int(diff.max()) if diff.numel() else 0
    max_err[name] = max(max_err[name] or 0, err)
    if not (equal_mod_inf(got, want) if mod_inf else torch.equal(got, want)):
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


def bound(n_bytes: int, n_ops: int, chain_cells: int = 0):
    """(bound_ms, bound_by): the largest of bytes over the memory rate,
    integer operations over the int32 rate and, for a wavefront, the cells
    of its longest dependency path times two dependent DPX instructions at
    the measured latency (see the module docstring)."""
    times = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3, "operations": n_ops / INT32_OPS_PER_S * 1e3}
    if chain_cells:
        if dpx_ns["ns"] is None:
            raise AssertionError("the DPX latency was not measured (phase 1)")
        times["chain"] = chain_cells * 2 * dpx_ns["ns"] * 1e-6
    by = max(times, key=times.get)
    return times[by], by


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


def sweep_flankless_bound(sub_rows, dd, seeds, io, ie, chain=True):
    n_rows, Wq = sub_rows.shape
    return bound(nbytes(sub_rows, dd, seeds, io, ie) + nbytes(seeds),
                 n_rows * Wq * SWEEP_OPS_PER_CELL, (n_rows + Wq - 1) if chain else 0)


def sweep_flanked_bound(subs, dd, seeds, io, ie, *, L, R, climb, chain=True):
    _, n_rows, Wq = subs.shape
    climbing = R + (L if climb else 0)
    return bound(nbytes(subs, dd, seeds, io, ie) + nbytes(seeds),
                 n_rows * Wq * SWEEP_OPS_PER_CELL * (1 + climbing),
                 (n_rows + Wq + L + R - 1) if chain else 0)


def module_scan_bound(seedT, lut, sdo, sde, pchar, pmask, io, ie, *, allow_sdel,
                      B_plain=None, skip_from=0):
    """(bound_ms, bound_by, live share, share dead at level 0).  The exact
    mode runs every level of every problem.  The skipping mode (`skip_from`
    > 0, with the plain result `B_plain`) has to close and emit the levels of
    a problem up to the first whose minimum reaches `skip_from`, and to step
    between them; the live share is those levels over all."""
    NB, C, W = seedT.shape
    L = pchar.shape[0]
    close_emit = (SCAN_CLOSE_OPS if allow_sdel else 0) + SCAN_EMIT_OPS
    if skip_from > 0:
        dead = B_plain >= skip_from
        first = torch.where(dead.any(0), dead.int().argmax(0), L)  # (NB, C)
        levels = int((first + 1).sum())
        dead0 = float((first == 0).float().mean()) if first.numel() else 0.0
    else:
        levels, dead0 = NB * C * (L + 1), 0.0
    ops = W * (levels * close_emit + (levels - NB * C) * SCAN_STEP_OPS)
    out_bytes = 4 * (L + 1) * NB * C
    live = levels / max(NB * C * (L + 1), 1)
    return (*bound(nbytes(seedT, lut, sdo, sde, pchar, pmask, io, ie) + out_bytes, ops),
            live, dead0)


def module_inputs(gen, NB, C, W, L, A=6):
    """Seeded module-scan inputs with negative table entries.  Of every four
    entry rows, one has infinite seeds (dead at level 0) and one a mask that
    is infinite from a random level on (dead from there), so that the
    skipping mode leaves problems at many levels."""
    # Finite seeds >= L keep every value nonnegative (see ops/common.py).
    seedT = rand_costs(gen, (NB, C, W), L, L + 40, 0.5, 0.05)
    seedT[1::4] = DEV_INF
    lut = rand_costs(gen, (A, C, W), -1, 7, 0.05, 0.05)
    lut[A - 1] = DEV_INF
    sdo = rand_costs(gen, (C, W), 0, 6, 0.05)
    sde = rand_costs(gen, (C, W), 0, 3, 0.05)
    pchar = torch.randint(0, A, (L, NB), generator=gen, dtype=torch.int32).to(DEV)
    pmask = torch.where(torch.rand((L, NB), generator=gen) < 0.02, DEV_INF, 0).to(torch.int32)
    cut = torch.randint(0, L + 1, (NB,), generator=gen)
    dying = torch.arange(L)[:, None] >= cut[None, :]
    dying[:, torch.arange(NB) % 4 != 3] = False
    pmask = torch.where(dying, DEV_INF, pmask).to(DEV)
    pgo = rand_costs(gen, (A,), -1, 6)
    pge = rand_costs(gen, (A,), -1, 3)
    io = sat_add(pgo[pchar.long()], pmask)
    ie = sat_add(pge[pchar.long()], pmask)
    return seedT, lut, sdo, sde, pchar, pmask, io, ie


def scan_skip_from(args, allow_sdel):
    """skip_from of the skipping mode for module-scan inputs `args`."""
    _, lut, sdo, _, pchar, pmask, io, ie = args
    skip_from = dead_state_threshold(lut, sdo, pmask, io, ie, pchar.shape[0],
                                     allow_sdel=allow_sdel)
    if skip_from <= 0:
        raise AssertionError("module_scan: these inputs give no skipping mode")
    return skip_from


def module_scan_build_report():
    """What the build says of the module scan: registers, stack and spill
    bytes of each instantiation (by K, the offsets a lane) from ptxas, and
    how often each DPX instruction stands in its SASS (cuobjdump)."""
    per_k = {}
    for r in _build.resources("module_scan"):
        k = re.search(r"ILi(\d+)E", r["name"])
        per_k[int(k.group(1)) if k else r["name"]] = [
            r["registers"], r["stack"], r["spill_stores"] + r["spill_loads"]]
    say(1, module_scan_registers_stack_spill_by_K=per_k,
        most_registers=max(v[0] for v in per_k.values()),
        instantiations_spilling=sorted(k for k, v in per_k.items() if v[2]))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        say(1, module_scan_sass="cuobjdump not found")
        return
    sass = subprocess.run([tool, "-sass", _build.library().paths["module_scan"]],
                          capture_output=True, text=True, check=True).stdout
    ops = re.findall(r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_]+)", sass, re.M)
    dpx = {op: ops.count(op) for op in sorted(set(ops)) if op.startswith(("VIADD", "VIMNMX"))}
    say(1, module_scan_sass_instructions=len(ops), dpx=dpx)
    if not dpx:
        raise AssertionError("module_scan: no DPX instruction in the SASS")


def sweep_build_report():
    """ptxas's registers, stack and spill bytes of each sweep instantiation:
    K (columns a lane), F = 1 or F > 1, and whether it holds the hand-over
    through the scratch rows (more super-tiles than warps: "cross")."""
    per = {}
    for r in _build.resources("sweep"):
        m = re.search(r"sweep_kernelILi(\d+)ELb(\d)ELb(\d)E", r["name"])
        if m:
            name = f"K{m.group(1)}_{'flanked' if m.group(2) == '1' else 'flankless'}"
            per[name + ("_cross" if m.group(3) == "1" else "")] = [
                r["registers"], r["stack"], r["spill_stores"] + r["spill_loads"]]
    if len(per) != 4:
        raise AssertionError(f"sweep: ptxas reported {sorted(per)}")
    say(1, sweep_registers_stack_spill=per,
        instantiations_spilling=sorted(k for k, v in per.items() if v[2]))


def measure_dpx_latency():
    """Clocks of one dependent __viaddmin_s32 (a one-thread loop of 2^26 in
    csrc/sweep.cu, a few times) and the SM clock nvidia-smi saw meanwhile."""
    clocks, card = under_load(lambda: min(dpx_chain_clocks(DEV, 1 << 26) for _ in range(3)))
    mhz = card.get("sm_mhz_median")
    if not mhz:
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True).stdout.split()[0])
    dpx_ns.update(clocks=clocks, sm_mhz=mhz, ns=clocks / mhz * 1e3)
    say(1, dpx_dependent_clocks_an_instruction=clocks, sm_mhz_sampled=mhz,
        dpx_dependent_ns=dpx_ns["ns"], card_under_load=card)


def phase1():
    t0 = time.monotonic()
    _build.library()
    say(1, card=card_line(), torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], build_s=time.monotonic() - t0,
        devices=torch.cuda.device_count())
    module_scan_build_report()
    sweep_build_report()
    measure_dpx_latency()


def plane_major(seeds):
    """The (n_rows, planes, Wq) view of a plane-major copy of `seeds`."""
    return seeds.permute(1, 0, 2).contiguous().permute(1, 0, 2)


def negate_some(seeds):
    """Seeds with a part of the finite entries negative (a tie-break bonus
    can make a seed negative), beside the DEV_INF and DEV_INF - 1 ones."""
    return torch.where((seeds < 30) & (seeds % 3 == 0), -seeds, seeds)


def with_warps(name, warps, tables, seeds, kw):
    """The sweep `name` with the launch's warps (0: through its wrapper) or
    held to fewer (through the wrapper's launch)."""
    subs, dd, io, ie = tables
    if not warps:
        return (sweep_flanked if kw else sweep_flankless)(subs, dd, seeds, io, ie, **kw)
    flanks = (kw["L"], kw["R"], kw["climb"]) if kw else (0, 0, False)
    return sweep_ops._launch(name, subs, dd, seeds, io, ie, *flanks, warps=warps)


def sweep_strip_edges(gen):
    """Both sweeps at the edges of a super-tile (128 columns) and of a
    block's eight (1024: one more goes through the scratch rows), at one
    column and beyond, with the launch's warps and held to 1 and 3 (a warp
    then takes several super-tiles in turn), for one row and for several,
    the flanked sweep up to F = 16, in both seed layouts, on negative seeds
    beside infinite ones."""
    widths = [1, 127, 128, 129, 700, 1023, 1024, 1025, 1500]
    warps_held = [0, 1, 3]
    compared = 0
    for Wq in widths:
        for n_rows in (1, 23):
            sub, dd, seeds, io, ie = sweep_inputs(gen, n_rows, Wq)
            cases = [("sweep_flankless", (sub, dd, io, ie), negate_some(seeds), {})]
            for L, R, climb in ((2, 2, True), (0, 3, False), (7, 8, True)):
                a = flanked_sweep_inputs(gen, n_rows, Wq, L + R + 1)
                cases.append(("sweep_flanked", (a[0], a[1], a[3], a[4]), negate_some(a[2]),
                              dict(L=L, R=R, climb=climb)))
            for name, (subs, dd, io, ie), seeds, kw in cases:
                plain = sweep_flanked_torch if kw else sweep_flankless_torch
                want = plain(subs, dd, seeds, io, ie, **kw)
                for warps in warps_held:
                    what = f"warps={warps} n_rows={n_rows} Wq={Wq} {kw}"
                    compare(name, with_warps(name, warps, (subs, dd, io, ie), seeds, kw), want, what)
                    compare(name, with_warps(name, warps, (subs, dd, io, ie), plane_major(seeds),
                                             kw).contiguous(), want, what + " plane-major")
                    compared += 2
    say(2, kernel="sweep", strip_edges=True, widths=widths, warps=warps_held, compared=compared,
        equal=True)


def scratch_noise(n_rows, Wq, F):
    """Leave noise of any sign where the allocator will put the next launch's
    two scratch buffers: the wavefront computes on what they hold outside
    the field, and none of it may reach a cell of the field."""
    n_in, n_out = ctypes.c_longlong(), ctypes.c_longlong()
    _build.check(_build.library().tsa_sweep_scratch(n_rows, Wq, F, ctypes.byref(n_in),
                                                    ctypes.byref(n_out)), "scratch")
    noise = [torch.randint(-2**31, 2**31 - 1, (n.value,), dtype=torch.int32, device=DEV)
             for n in (n_in, n_out)]
    torch.cuda.synchronize()
    del noise


def sweep_hand_over_stress(gen, repeats=10):
    """Many rows through 8 warps, over and over, each run on scratch buffers
    that hold noise: the hand-over of the last columns between warps through
    shared memory (1024 columns) and through the scratch rows (1500)."""
    n_rows = 1200
    for Wq in (1024, 1500):
        sub, dd, seeds, io, ie = sweep_inputs(gen, n_rows, Wq)
        a = flanked_sweep_inputs(gen, n_rows, Wq, 5)
        for name, tables, seeds, kw in (
                ("sweep_flankless", (sub, dd, io, ie), negate_some(seeds), {}),
                ("sweep_flanked", (a[0], a[1], a[3], a[4]), negate_some(a[2]),
                 dict(L=2, R=2, climb=True))):
            plain = sweep_flanked_torch if kw else sweep_flankless_torch
            want = plain(tables[0], tables[1], seeds, tables[2], tables[3], **kw)
            for i in range(repeats):
                scratch_noise(n_rows, Wq, seeds.shape[1] // 3)
                compare(name, with_warps(name, 0, tables, seeds, kw), want,
                        f"stress n_rows={n_rows} Wq={Wq} run {i}")
    say(2, kernel="sweep", hand_over_stress=True, n_rows=n_rows, widths=[1024, 1500],
        repeats=repeats, scratch_holds_noise=True, equal=True)


def phase2():
    gen = torch.Generator().manual_seed(2)
    phase2_sweeps(gen)
    phase2_scan(gen)


def phase2_sweeps(gen):
    for n_rows, Wq in ((17, 1), (40, 33), (1001, 1001), (300, 2100)):
        args = sweep_inputs(gen, n_rows, Wq)
        want = sweep_flankless_torch(*args)
        compare("sweep_flankless", sweep_flankless(*args), want, f"n_rows={n_rows} Wq={Wq}")
        planes = plane_major(args[2])
        got = sweep_flankless(args[0], args[1], planes, args[3], args[4])
        if got.stride() != planes.stride():
            raise AssertionError("sweep_flankless: plane-major seeds gave another layout")
        compare("sweep_flankless", got.contiguous(), want, f"n_rows={n_rows} Wq={Wq} plane-major")
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
            planes = plane_major(seeds)
            got = sweep_flanked(subs, dd, planes, io, ie, **kw)
            if got.stride() != planes.stride():
                raise AssertionError(f"sweep_flanked {what}: plane-major seeds gave another layout")
            compare("sweep_flanked", got.contiguous(), want, what + " plane-major")
            say(2, kernel="sweep_flanked", L=L, R=R, climb=climb, n_rows=n_rows, Wq=Wq,
                equal=True,
                ms=cuda_ms(lambda: sweep_flanked(subs, dd, seeds, io, ie, **kw), 10),
                plain_ms=cuda_ms(lambda: sweep_flanked_torch(subs, dd, seeds, io, ie, **kw), 1))
    sweep_strip_edges(gen)
    sweep_hand_over_stress(gen)


def phase2_scan(gen):
    # (NB, C, W, L): the shapes held since the first slice, then widths at
    # the edges of a lane's run (W = 32 K and its neighbours), the main
    # path's, a 1000-bp pair's and the widest, on NB not a multiple of the
    # warps a block.
    shapes = [(64, C, 201, L) for C in (8, 64) for L in (5, 64)]
    shapes += [(13, 8, W, 12) for W in (1, 31, 32, 33, 521, 545, 1100, 2048)]
    for fwd in (True, False):
        for sdel in (True, False):
            for NB, C, W, L in shapes:
                args = module_inputs(gen, NB, C, W, L)
                kw = dict(fwd=fwd, allow_sdel=sdel)
                skip = dict(kw, skip_from=scan_skip_from(args, sdel))
                want = module_scan_torch(*args, **kw)
                what = f"fwd={fwd} sdel={sdel} NB={NB} C={C} W={W} L={L}"
                compare("module_scan", module_scan(*args, **kw), want, what + " exact")
                compare("module_scan", module_scan(*args, **skip), want, what + " skipping",
                        mod_inf=True)
                say(2, kernel="module_scan", NB=NB, C=C, W=W, L=L, fwd=fwd,
                    allow_sdel=sdel, equal=True, equal_mod_inf_skipping=True,
                    ms=cuda_ms(lambda: module_scan(*args, **kw), 10),
                    skipping_ms=cuda_ms(lambda: module_scan(*args, **skip), 10),
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


def sweep_call_parts(call, n_rows, Wq, F, reps=20):
    """What one wrapper call of a sweep is made of: device microseconds of
    each of its three kernels (torch.profiler), and on the host's clock the
    microseconds to queue a call and, of those, to allocate its two scratch
    buffers (the allocator hands back the blocks of the call before)."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    kernels_us = {}
    for e in prof.key_averages():
        for part in ("skew_in_kernel", "sweep_kernel", "skew_out_kernel"):
            if part in e.key:
                kernels_us[part] = kernels_us.get(part, 0.0) + e.device_time_total / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    queue_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    n_in, n_out = ctypes.c_longlong(), ctypes.c_longlong()
    _build.check(_build.library().tsa_sweep_scratch(n_rows, Wq, F, ctypes.byref(n_in),
                                                    ctypes.byref(n_out)), "scratch")
    t0 = time.perf_counter()
    for _ in range(reps):
        a = torch.empty(n_in.value, dtype=torch.int32, device=DEV)
        b = torch.empty(n_out.value, dtype=torch.int32, device=DEV)
        del a, b
    alloc_us = (time.perf_counter() - t0) / reps * 1e6
    return dict(kernels_us=kernels_us or "not measured (the profiler saw no kernel)",
                host_queue_us_a_call=queue_us, host_scratch_alloc_us_a_call=alloc_us,
                scratch_bytes=[4 * n_in.value, 4 * n_out.value])


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
    seeds = root[0].permute(1, 0, 2)  # the engine's plane-major field, in place
    args = (sub_rows, dd, seeds, io, ie)
    compare("sweep_flankless", sweep_flankless(*args), sweep_flankless_torch(*args), "main shapes")
    timings = {"sweep_flankless": (cuda_ms(lambda: sweep_flankless(*args), 20),
                                   cuda_ms(lambda: sweep_flankless_torch(*args), 1),
                                   *sweep_flankless_bound(*args))}
    say(5, kernel="sweep_flankless", shape=list(seeds.shape), equal=True,
        ms=timings["sweep_flankless"][0], plain_ms=timings["sweep_flankless"][1],
        bound_ms=timings["sweep_flankless"][2], bound_by=timings["sweep_flankless"][3],
        bytes_or_operations_bound=sweep_flankless_bound(*args, chain=False),
        **sweep_call_parts(lambda: sweep_flankless(*args), seeds.shape[0], seeds.shape[2], 1))

    for km, e_base, margs in main_pair_chunks(eng, root):
        kw = dict(fwd=km.dk == 0, allow_sdel=km.allow_sdel)
        skip = dict(kw, skip_from=km.skip_from)
        if km.skip_from <= 0:
            raise AssertionError("main pair: the kind's tables give no skipping mode")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        want = module_scan_torch(*margs, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.monotonic() - t0) * 1e3
        kind = [km.spec.pk, km.spec.sk, km.dk]
        compare("module_scan", module_scan(*margs, **kw), want,
                f"kind {kind} chunk {e_base} exact")
        compare("module_scan", module_scan(*margs, **skip), want,
                f"kind {kind} chunk {e_base} skipping", mod_inf=True)
        if "module_scan" not in timings:  # the reported times, with the card's clocks
            (exact_ms, ms), card = under_load(lambda: (
                cuda_ms(lambda: module_scan(*margs, **kw), 20),
                cuda_ms(lambda: module_scan(*margs, **skip), 20)))
            say(5, kernel="module_scan", card_under_load=card)
        else:
            exact_ms = cuda_ms(lambda: module_scan(*margs, **kw), 3)
            ms = cuda_ms(lambda: module_scan(*margs, **skip), 3)
        exact_bound_ms, exact_by, _, _ = module_scan_bound(*margs, allow_sdel=km.allow_sdel)
        bound_ms, bound_by, live, dead0 = module_scan_bound(
            *margs, allow_sdel=km.allow_sdel, B_plain=want, skip_from=km.skip_from)
        # the main path launches the skipping mode: its numbers are reported
        timings.setdefault("module_scan", (ms, plain_ms, bound_ms, bound_by))
        NB, Cc, W = margs[0].shape
        say(5, kernel="module_scan", kind=kind, e_base=e_base, NB=NB, C=Cc, W=W,
            L=km.L, fwd=kw["fwd"], allow_sdel=km.allow_sdel, equal=True,
            equal_mod_inf_skipping=True, skip_from=km.skip_from,
            exact_ms=exact_ms, exact_bound_ms=exact_bound_ms, exact_bound_by=exact_by,
            ms=ms, bound_ms=bound_ms, bound_by=bound_by, live_share=live,
            dead_at_level_0_share=dead0, plain_ms=plain_ms)
    return timings


def main_pair_chunks(eng, root):
    """(kind module, entry column, module-scan inputs) of the chunks the
    smoke holds the module scan on: for every active cross kind of the
    engine's first reentry round (forward and reverse, each with its own
    allow_sdel), the chunk at entry column 0 and the middle live chunk after
    it."""
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
            yield km, e_base, (
                seedT, t["lut"][:, sl].contiguous(), t["sdo"][sl].contiguous(),
                t["sde"][sl].contiguous(), t["pchar_l"], t["pmask_l"], t["io_l"], t["ie_l"])


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
            equal=True, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            bytes_or_operations_bound=sweep_flanked_bound(*args, **kw, chain=False),
            **sweep_call_parts(lambda: sweep_flanked(*args, **kw), n_rows, Wq, F))
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
