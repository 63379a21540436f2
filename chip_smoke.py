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
     problems die (infinite seed rows, a mask that turns infinite); then the
     kernels' new variants: the module scan of modules wider than 2048
     offsets (2049 and 4096: T warps a problem) in both modes, its diagonal
     mode (same-sequence kinds) at the main pair's shapes, and both kernels'
     pair axes at phase 7's shapes (eight sweeps of 513 x 513 at F = 1 and
     5 on scratch buffers that hold noise, eight module-scan chunks of
     NB 513 / C 64 / W 613 / L 512), each pair also against its own launch;
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
     path's shapes (the root seeds and a later round's seeds);
  7. the batched engine at full width: eight seeded planted pairs of
     380-500 bp, poison-padded into the (512, 512) bucket, through
     tsalign_tpu_torch.align_pairs(..., device="cuda"), under the default
     configuration and under the flanked default: every record reprices to
     its cost, the sweep's and the module scan's pair axes and the diagonal
     mode launch, and the shortest and the longest pair cost the same
     through the single-pair port (its wall beside the batch's, and the
     batch's kernel time on the card by CUDA events around each launch);
     then the eight pairs of tests/fixtures/torch_port_batch_pairs.json
     (60-128 bp, two buckets): cost and CIGAR equal the JAX package's
     batched engine's (recorded on the CPU);
  8. chained mode at the reference's scale: the seeded 230 kb construction
     of scripts/validate_chain_scale.py (10 planted reverse-complement
     stretches, 98 substitutions) under its narrow configuration
     (tests/fixtures/torch_port_chain_cfg.tsa) through
     tsalign_tpu_torch.chain_align(..., target_segment=1024, device="cuda"):
     the cost equals the constructed optimum (216), the alignment reprices
     to it with 10 template switches, the batched engine's sweep and
     module-scan pair axes and the diagonal mode launch, no window goes to
     the numpy engine; the wall split by step, the batches by bucket and
     pair count, the kernels' device time by CUDA events; then those three
     kernels against their plain versions at the largest launch the chain
     made of each (32 pairs in the 256 bucket), and the three pairs of
     tests/fixtures/torch_port_chain_pairs.json (1.5 kb and 3 kb
     constructions, a 160 bp pair under a random configuration): cost,
     CIGAR, segments, anchors and rejoined cuts equal the JAX package's
     (recorded on the CPU);
  9. the command line on the card: tsalign_tpu_torch.cli.main([...]) in this
     process, in a temporary directory.  (a) `align -r -q -o` on the
     flankless main pair without --device (the default is the card): the
     record, without its wall-time lines, equals phase 5's, and the flankless
     sweep, the module scan and its diagonal mode launch; (b) `align -p -c -o
     --device cuda` on the flanked main pair with the flanked default as
     display() text in cfg/config.tsa: the record equals phase 6's and the
     flanked sweep launches; (c) `preprocess` of the narrow configuration at
     the 230 kb bucket, then `align --alignment-method a-star-chain-ts
     --cache-directory --force-no-preprocessing` on phase 8's construction:
     the cost is 216, the record parses back and reprices to it, its CIGAR
     equals phase 8's, the pair axes launch; (d) `show -s -a -c -e` on the
     three records (the plain text shows a template switch, the SVG parses)
     and `show -n` with a --no-ts record of the flankless pair; (e) `align
     --profile DIR` on the 60 bp fixture pair: the Chrome trace it writes
     names the kernels of csrc/sweep.cu and csrc/module_scan.cu.  One line a
     step: wall, cost, launches, the kernels' device ms (CUDA events);
 10. the routes of the rounds loop.  (a) The compact live-column route
     against the chunked one on the card: at the flankless main pair's first
     round after round 1 in which the host loop sends a kind compact, every
     such kind's reentry field both ways (torch.equal), with each route's
     launches and the share of its (entry row, column) problems dead at level
     0; then at a 160 x 150 pair (chunk 16) the same, and kind_sel_chunks on
     the card against its plain run on the CPU for a cross and a
     same-sequence kind (equal_mod_inf: the card runs the skipping mode).
     (b) Both main pairs through the facade's host loop (fused=False) on the
     chunked route (the private switch engine._COMPACT_ROUTE off) and the
     compact route in turns, chunked, compact, chunked, compact, from cold
     memos: the records are equal but for their wall lines; each run's wall,
     engine passes and rounds, module-scan launches, assembly calls, compact
     launches, mean live columns and bucket, kernels' device ms.  (c) The
     fused rounds loop: the flankless main pair through the facade's default
     (the single-pair delegation) against (b)'s compact run (the records may
     differ only in FUSED_MAY_DIFFER), then phase 7's flankless batch
     (K-scaled, BatchedTSAligner with the fused and the host loop: costs,
     rounds and alignments equal); at most two control reads a round of a
     loop, none larger than the all-done flag and eight kinds' chunk
     liveness; the peak device memory.  (d) The facade's default runs the
     fused loop, with max_template_switches=1 or prune_range the host loop.
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

import collections
import contextlib
import ctypes
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import xml.dom.minidom

import numpy as np
import torch

# Python puts this script's directory first on sys.path, so the package
# imports from the checkout it sits in (and fails where it sits alone).
import tsalign_tpu_torch
from tsalign_tpu_torch import _build
from tsalign_tpu_torch.alignment import Alignment, TemplateSwitchEntrance, TemplateSwitchExit
from tsalign_tpu_torch.alphabet import get_alphabet
from tsalign_tpu_torch.config import TemplateSwitchConfig
from tsalign_tpu_torch.costs import INF, GapAffineCostTable
from tsalign_tpu_torch.engine import TorchAligner, next_seeds
from tsalign_tpu_torch.ops.common import (DEV_INF, DEV_INF_THRESH, dead_state_threshold,
                                          equal_mod_inf, sat_add)
from tsalign_tpu_torch.ops.module_scan import launch_plan, module_scan, module_scan_diag
from tsalign_tpu_torch.ops.modules import module_scan_torch
from tsalign_tpu_torch.ops import sweep as sweep_ops
from tsalign_tpu_torch.ops.sweep import (dpx_chain_clocks, sweep_flanked, sweep_flanked_torch,
                                         sweep_flankless, sweep_flankless_torch)
from tsalign_tpu_torch.oracle import OracleAligner
from tsalign_tpu_torch.parallel.batch_ts import align_pairs
from tsalign_tpu_torch.pricing import price_alignment
from tsalign_tpu_torch.result import AlignmentResult

DEV = "cuda"
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures")
FIXTURE = os.path.join(FIXTURES, "torch_port_pairs.json")
FLANKED_FIXTURE = os.path.join(FIXTURES, "torch_port_flanked_pairs.json")
# (name, seed, reference length, planted reverse-complement length, SNPs) of
# the flanked fixture's pairs; each also gets the two flank substitutions.
FLANKED_FIXTURE_PAIRS = (("flanked_60", 1060, 60, 12, 2), ("flanked_90", 1090, 90, 16, 2),
                         ("flanked_120", 1120, 120, 20, 3))
# (name, seed, reference length, planted reverse-complement length, SNPs) of
# the batch fixture's pairs: two length buckets (64 and 128).
BATCH_FIXTURE = os.path.join(FIXTURES, "torch_port_batch_pairs.json")
BATCH_FIXTURE_PAIRS = (("batch_60", 2060, 60, 12, 2), ("batch_64", 2064, 64, 10, 2),
                       ("batch_90", 2090, 90, 16, 2), ("batch_100", 2100, 100, 16, 3),
                       ("batch_110", 2110, 110, 18, 3), ("batch_118", 2118, 118, 18, 3),
                       ("batch_124", 2124, 124, 20, 3), ("batch_128", 2128, 128, 20, 4))
# Chained mode (phase 8): the narrow configuration of
# scripts/validate_chain_scale.py, and the chained alignments of three pairs
# recorded from the JAX package (scripts/make_torch_port_fixture.py chain).
CHAIN_CFG = os.path.join(FIXTURES, "torch_port_chain_cfg.tsa")
CHAIN_FIXTURE = os.path.join(FIXTURES, "torch_port_chain_pairs.json")
CHAIN_SEED = 230147
CHAIN_LENGTH = 230_000  # the reference's own scale (its 230 kb region)
# The main pairs' names, as the command line reads them from a FASTA header
# ">reference main_pair" (phase 9 compares its records with phases 5 and 6).
MAIN_NAMES = ("reference main_pair", "query main_pair")
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
    # the variants of the two kernels: the module scan of a module wider than
    # 2048 offsets (T warps a problem), its diagonal mode (same-sequence
    # kinds), and both kernels' pair axes (the batched engine)
    "module_scan_wide": {
        "route": "cuda",
        "source": "tsalign_tpu_torch/csrc/module_scan.cu",
        "replaces": "tsalign_tpu/ops/pallas_module.py:142",
    },
    "module_scan_diag": {
        "route": "cuda",
        "source": "tsalign_tpu_torch/csrc/module_scan.cu",
        "replaces": "tsalign_tpu/ops/pallas_module.py:142",
    },
    "module_scan_pairs": {
        "route": "cuda",
        "source": "tsalign_tpu_torch/csrc/module_scan.cu",
        "replaces": "tsalign_tpu/ops/pallas_module.py:142",
    },
    "sweep_flankless_pairs": {
        "route": "cuda",
        "source": "tsalign_tpu_torch/csrc/sweep.cu",
        "replaces": "tsalign_tpu/ops/pallas_sweep.py:238",
    },
    "sweep_flanked_pairs": {
        "route": "cuda",
        "source": "tsalign_tpu_torch/csrc/sweep.cu",
        "replaces": "tsalign_tpu/ops/pallas_sweep.py:392",
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
    between them; the live share is those levels over all.  A leading pair
    axis on every argument sums the sets' work; a 2-D seed (the diagonal
    mode) is a problem set of one column."""
    if seedT.dim() == 4:
        work = [module_scan_work(*(t[z] for t in (seedT, lut, sdo, sde, pchar, pmask, io, ie)),
                                 allow_sdel=allow_sdel, skip_from=skip_from,
                                 B_plain=None if B_plain is None else B_plain[z])
                for z in range(seedT.shape[0])]
    else:
        work = [module_scan_work(seedT, lut, sdo, sde, pchar, pmask, io, ie,
                                 allow_sdel=allow_sdel, B_plain=B_plain, skip_from=skip_from)]
    levels = sum(w[2] for w in work)
    return (*bound(sum(w[0] for w in work), sum(w[1] for w in work)),
            levels / max(sum(w[3] for w in work), 1),
            sum(w[4] * w[3] for w in work) / max(sum(w[3] for w in work), 1))


def module_scan_work(seedT, lut, sdo, sde, pchar, pmask, io, ie, *, allow_sdel,
                     B_plain=None, skip_from=0):
    """(bytes, operations, levels run, levels in all, share dead at level 0)
    of one problem set (see `module_scan_bound`)."""
    if seedT.dim() == 2:
        seedT = seedT[:, None]
        B_plain = None if B_plain is None else B_plain[..., None]
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
    return (nbytes(seedT, lut, sdo, sde, pchar, pmask, io, ie) + out_bytes, ops, levels,
            NB * C * (L + 1), dead0)


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
        # K, "_wide" for several warps a problem, "_diag" for the diagonal mode
        k = re.search(r"ILi(\d+)ELb([01])ELb([01])E", r["name"])
        per_k[f"{k.group(1)}{'_wide' * int(k.group(2))}{'_diag' * int(k.group(3))}"
              if k else r["name"]] = [
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


def scratch_noise(n_rows, Wq, F, P=1):
    """Leave noise of any sign where the allocator will put the next launch's
    two scratch buffers (of P sweeps): the wavefront computes on what they
    hold outside the field, and none of it may reach a cell of the field."""
    n_in, n_out = ctypes.c_longlong(), ctypes.c_longlong()
    _build.check(_build.library().tsa_sweep_scratch(n_rows, Wq, F, ctypes.byref(n_in),
                                                    ctypes.byref(n_out)), "scratch")
    noise = [torch.randint(-2**31, 2**31 - 1, (P * n.value,), dtype=torch.int32, device=DEV)
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
    return phase2_variants(gen)


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


def phase2_variants(gen):
    """The kernels' new variants against their plain versions: the module
    scan of wide modules (T warps a problem) in both modes, its diagonal
    mode at the main pair's same-sequence shapes, and both kernels' pair
    axes at the shapes of phase 7's batch (eight pairs in the 512 bucket),
    each pair also against its own launch.  Returns each variant's (ms,
    plain_ms, bound_ms, bound_by)."""
    timings = {}
    for fwd in (True, False):
        for NB, C, W, L in ((13, 8, 2049, 12), (13, 8, 4096, 12), (32, 16, 4096, 64)):
            args = module_inputs(gen, NB, C, W, L)
            kw = dict(fwd=fwd, allow_sdel=True)
            skip = dict(kw, skip_from=scan_skip_from(args, True))
            want = module_scan_torch(*args, **kw)
            what = f"wide fwd={fwd} NB={NB} C={C} W={W} L={L}"
            compare("module_scan_wide", module_scan(*args, **kw), want, what + " exact")
            compare("module_scan_wide", module_scan(*args, **skip), want, what + " skipping",
                    mod_inf=True)
            ms = cuda_ms(lambda: module_scan(*args, **kw), 5)
            plain_ms = cuda_ms(lambda: module_scan_torch(*args, **kw), 1)
            bound_ms, bound_by, _, _ = module_scan_bound(*args, allow_sdel=True)
            say(2, kernel="module_scan_wide", NB=NB, C=C, W=W, L=L, fwd=fwd,
                warps_a_problem=launch_plan(W, args[1].shape[0])[1], equal=True,
                equal_mod_inf_skipping=True, ms=ms,
                skipping_ms=cuda_ms(lambda: module_scan(*args, **skip), 5), plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)
            timings["module_scan_wide"] = (ms, plain_ms, bound_ms, bound_by)
    # the main pair's same-sequence kinds: 501 problems of 601 (forward) and
    # 501 (reverse) offsets through 500 levels
    for fwd, W in ((True, 601), (False, 501)):
        seedT, lut, sdo, sde, pchar, pmask, io, ie = module_inputs(gen, 501, 501, W, 500)
        args = (seedT[torch.arange(501), torch.arange(501)].contiguous(), lut, sdo, sde,
                pchar, pmask, io, ie)
        kw = dict(fwd=fwd, allow_sdel=True)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        want = module_scan_torch(*args, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.monotonic() - t0) * 1e3
        compare("module_scan_diag", module_scan_diag(*args, **kw), want, f"diag fwd={fwd} W={W}")
        ms = cuda_ms(lambda: module_scan_diag(*args, **kw), 5)
        bound_ms, bound_by, _, _ = module_scan_bound(*args, allow_sdel=True)
        say(2, kernel="module_scan_diag", NB=501, W=W, L=500, fwd=fwd, equal=True, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        timings.setdefault("module_scan_diag", (ms, plain_ms, bound_ms, bound_by))
    # the pair axes at the 512 bucket: 8 sweeps of 513 x 513 (F = 1 and 5),
    # 8 module scans of a chunk (NB 513, C 64, W 613, L 512)
    P, n = 8, 513
    for F in (1, 5):
        sets = ([sweep_inputs(gen, n, n) for _ in range(P)] if F == 1
                else [flanked_sweep_inputs(gen, n, n, F) for _ in range(P)])
        kw = {} if F == 1 else dict(L=2, R=2, climb=True)
        name = "sweep_flankless_pairs" if F == 1 else "sweep_flanked_pairs"
        # one wrapper: a pair axis on its arguments makes it one launch of P pairs
        single = pairs = sweep_flankless if F == 1 else sweep_flanked
        plain = sweep_flankless_torch if F == 1 else sweep_flanked_torch
        sets = [[a[0], a[1], negate_some(a[2]), a[3], a[4]] for a in sets]
        stacked = [torch.stack(ts) for ts in zip(*sets)]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        wants = [plain(*ts, **kw) for ts in sets]
        torch.cuda.synchronize()
        plain_ms = (time.monotonic() - t0) * 1e3
        for layout in ("rows", "planes"):
            if layout == "planes":
                stacked[2] = plane_major_pairs(stacked[2])
            for run in range(3):
                scratch_noise(n, n, F, P)
                got = pairs(*stacked, **kw)
                for z, ts in enumerate(sets):
                    compare(name, got[z].contiguous(), wants[z], f"pair {z} {layout} run {run}")
        for z, ts in enumerate(sets):
            compare(name, single(*ts, **kw), wants[z], f"pair {z} alone")
        ms = cuda_ms(lambda: pairs(*stacked, **kw), 10)
        single_ms = cuda_ms(lambda: [single(*ts, **kw) for ts in sets], 3)
        b = [(sweep_flankless_bound if F == 1 else sweep_flanked_bound)(*ts, **kw, chain=False)
             for ts in sets]
        n_bytes = sum(nbytes(*ts) + nbytes(ts[2]) for ts in sets)
        ops = P * n * n * SWEEP_OPS_PER_CELL * (1 + (2 + 2 if F > 1 else 0))
        bound_ms, bound_by = bound(n_bytes, ops, n + n + F - 2)
        say(2, kernel=name, pairs=P, shape=[n, 3 * F, n], equal=True, scratch_holds_noise=True,
            ms=ms, single_launches_ms=single_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, bytes_or_operations_bound_of_one=b[0])
        timings[name] = (ms, plain_ms, bound_ms, bound_by)
    sets = [module_inputs(gen, n, 64, 613, 512) for _ in range(P)]
    stacked = [torch.stack(ts) for ts in zip(*sets)]
    kw = dict(fwd=False, allow_sdel=True)
    skip_from = max(scan_skip_from(ts, True) for ts in sets)  # sound for every set
    got = module_scan(*stacked, **kw)
    got_skip = module_scan(*stacked, **kw, skip_from=skip_from)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    wants = [module_scan_torch(*ts, **kw) for ts in sets]
    torch.cuda.synchronize()
    plain_ms = (time.monotonic() - t0) * 1e3
    for z, ts in enumerate(sets):
        compare("module_scan_pairs", got[z], wants[z], f"pair {z} exact")
        compare("module_scan_pairs", got_skip[z], wants[z], f"pair {z} skipping", mod_inf=True)
        compare("module_scan_pairs", got[z], module_scan(*ts, **kw), f"pair {z} alone")
    ms = cuda_ms(lambda: module_scan(*stacked, **kw, skip_from=skip_from), 3)
    exact_ms = cuda_ms(lambda: module_scan(*stacked, **kw), 3)
    single_ms = cuda_ms(lambda: [module_scan(*ts, **kw, skip_from=skip_from) for ts in sets], 3)
    bound_ms, bound_by, live, _ = module_scan_bound(
        *stacked, allow_sdel=True, B_plain=torch.stack(wants), skip_from=skip_from)
    say(2, kernel="module_scan_pairs", pairs=P, NB=n, C=64, W=613, L=512, equal=True,
        equal_mod_inf_skipping=True, ms=ms, exact_ms=exact_ms, single_launches_ms=single_ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, live_share=live)
    timings["module_scan_pairs"] = (ms, plain_ms, bound_ms, bound_by)
    return timings


def plane_major_pairs(seeds):
    """The (P, n_rows, planes, Wq) view of a plane-major copy of `seeds`."""
    return seeds.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)


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


def chain_config() -> TemplateSwitchConfig:
    """The narrow configuration of scripts/validate_chain_scale.py (jump
    offsets and anti-gaps within +-24, TS length 6..9): a window radius of 40."""
    with open(CHAIN_CFG) as f:
        return TemplateSwitchConfig.parse_plain(f.read(), get_alphabet("dna-n"))


def chain_construction(n: int, seed: int = CHAIN_SEED):
    """The seeded pair of scripts/validate_chain_scale.py: a random reference
    of n bases; the query copies it with a reverse-complemented 8-bp stretch
    every n / 10 bases and a substitution every n / 100 bases away from
    them.  Returns (reference, query, the constructed optimum under
    `chain_config`, the planted stretches) with the sequences as int8
    codes."""
    comp = get_alphabet("dna-n").complement_array()
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, size=n).astype(np.int8)
    qry = ref.copy()
    ts_sites = list(range(n // 20, n - 50, max(n // 10, 100)))
    for p in ts_sites:
        qry[p : p + 8] = [comp[c] for c in qry[p : p + 8]][::-1]
    snp_sites = [p for p in range(n // 40, n - 50, max(n // 100, 50))
                 if all(abs(p - t) > 60 for t in ts_sites)]
    for p in snp_sites:
        qry[p] = (qry[p] + 1) % 4
    return ref, qry, 2 * len(ts_sites) + 2 * len(snp_sites), len(ts_sites)


class ChainMeter:
    """Where one `chain_align` run spends its time, for the length of a
    `with` block: host seconds (after a synchronise) of the driver's steps
    (anchoring, chaining, the batched engine's traceback segments and its
    cost-only probes, the per-segment engine), each batch of the batched
    engine (traceback or probe, bucket, pairs, most rounds) and the largest
    launch of each kernel wrapper the batches call (its shapes).  It wraps
    the port's functions by name and puts them back on leaving."""

    def __init__(self):
        self.seconds = collections.Counter()
        self.calls = collections.Counter()
        self.batches = []
        self.shapes = {}

    def _patch(self, owner, name, wrap):
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        setattr(owner, name, wrap(orig))

    def _clocked(self, label_of):
        def wrap(orig):
            def run(*args, **kwargs):
                label = label_of(args, kwargs)
                t0 = time.monotonic()
                out = orig(*args, **kwargs)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                self.seconds[label] += time.monotonic() - t0
                self.calls[label] += 1
                return out
            return run
        return wrap

    def _shaped(self, name):
        def wrap(orig):
            def run(*args, **kwargs):
                shapes = [tuple(a.shape) for a in args]
                size = args[0].numel()
                if size > self.shapes.get(name, ((), 0))[1]:
                    self.shapes[name] = (shapes, size)
                return orig(*args, **kwargs)
            return run
        return wrap

    def __enter__(self):
        from tsalign_tpu_torch.chain import driver
        from tsalign_tpu_torch.ops import module_scan as scan_ops
        from tsalign_tpu_torch.parallel import batch_ts

        self._saved = []
        build = driver.Anchors.build
        self._patch(driver, "Anchors", lambda cls: type("Anchors", (), {
            "build": staticmethod(self._clocked(lambda a, k: "anchoring")(build))}))
        self._patch(driver, "compute_chain", self._clocked(lambda a, k: "chaining"))
        self._patch(driver, "_align_segments_batched", self._clocked(
            lambda a, k: "traceback_segments" if k["with_traceback"] else "cost_probes"))
        self._patch(driver, "_align_segment", self._clocked(
            lambda a, k: "per_segment_engine"))
        meter = self

        def batch_align(orig):
            def run(bt):
                t0 = time.monotonic()
                results = orig(bt)
                meter.batches.append(dict(
                    traceback=bool(bt.keep_fields), bucket=[bt.nr, bt.nq], pairs=bt.n_pairs,
                    rounds=max(r.rounds for r in results), s=time.monotonic() - t0))
                return results
            return run

        self._patch(batch_ts.BatchedTSAligner, "align", batch_align)
        self._patch(scan_ops, "module_scan", self._shaped("module_scan"))
        self._patch(batch_ts, "module_scan_diag", self._shaped("module_scan_diag"))
        self._patch(batch_ts, "sweep_flankless", self._shaped("sweep_flankless"))
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        return False

    def summary(self, wall: float) -> dict:
        """The wall split by step (the verification pass's own logic is what
        the steps leave of it) and the batches by mode, bucket and pairs."""
        split = dict(self.seconds)
        split["verification_logic"] = wall - sum(self.seconds.values())
        by = collections.defaultdict(lambda: dict(batches=0, windows=0, rounds_max=0, s=0.0))
        for b in self.batches:
            key = f"{'traceback' if b['traceback'] else 'probe'} {b['bucket'][0]}x{b['bucket'][1]} P={b['pairs']}"
            by[key]["batches"] += 1
            by[key]["windows"] += b["pairs"]
            by[key]["rounds_max"] = max(by[key]["rounds_max"], b["rounds"])
            by[key]["s"] += b["s"]
        return dict(wall_s=wall, split_s=split, calls=dict(self.calls), batches=dict(by),
                    engine_windows=sum(b["pairs"] for b in self.batches if b["traceback"]),
                    probe_windows=sum(b["pairs"] for b in self.batches if not b["traceback"]))


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
    res = tsalign_tpu_torch.align(r, q, device=DEV, reference_name=MAIN_NAMES[0],
                                  query_name=MAIN_NAMES[1])
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
    return r, q, counts, res.to_toml()


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
        route = eng._route(km, A_np, AS, best)
        later = [b for b in route[1] if b > 0] if route and route[0] == "chunked" else []
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
    res = aligner.align(r, q, reference_name=MAIN_NAMES[0], query_name=MAIN_NAMES[1])
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
    return r, q, counts, res.to_toml()


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


def batch_pairs(n_pairs=8):
    """Phase 7's pairs: seeded planted pairs of 380-500 bp, each poison-padded
    into the (512, 512) bucket."""
    rng = np.random.default_rng(700)
    return [planted_pair(rng, int(rng.integers(380, 501)), 40, 5, True) for _ in range(n_pairs)]


def phase7_batch(flanked):
    """The batched engine at full width: `align_pairs` on the card over the
    eight pairs of `batch_pairs`, under the default configuration or the
    flanked default.  Every record must reprice to its cost, and the
    shortest and the longest pair must cost the same through the single-pair
    port (timed in the same run).  Returns the launches of the batch and the
    batch itself (records, rounds, wall, the fused loop's control reads and
    peak memory) for phase 10."""
    al = get_alphabet("dna-n")
    cfg = flanked_default(al) if flanked else TemplateSwitchConfig.default(al)
    pairs = batch_pairs()
    rounds = {}

    def on_batch(idx, bt):
        if (bt.nr, bt.nq) != (512, 512):
            raise AssertionError(f"batch: bucket {(bt.nr, bt.nq)}, not (512, 512)")
        for i, res in zip(idx, bt.last_results):
            rounds[i] = res.rounds

    # align_pairs' redo pass: under the K-scaled tie-break (K = 2048 at this
    # bucket) a pair of a config that can rewind whose rounds could carry the
    # TS length to K is aligned again by the single-pair engine
    K = 2048
    lw = cfg.length_costs.maximum_finite_input()

    def redone(i):
        n = max(len(pairs[i][0]), len(pairs[i][1]), 1)
        l_eff = min(int(lw) if lw is not None else n, n)
        return cfg.can_rewind() and max(0, rounds[i] - 1) * l_eff >= K

    from tsalign_tpu_torch.parallel import fused_rounds

    fused_rounds.control_reads.clear()
    torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    _build.kernel_events = []
    torch.cuda.synchronize()
    t0 = time.monotonic()
    records = align_pairs(cfg, pairs, device=DEV, on_batch=on_batch)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    kernel_ms = _build.kernel_ms()
    _build.kernel_events = None
    counts = dict(_build.launches)
    per_round, largest = control_reads_by_round()
    peak = torch.cuda.max_memory_allocated()
    costs = []
    for (r, q), rec in zip(pairs, records):
        cost = rec.result.cost
        if flanked:
            priced, _ = reprice(cfg, al.encode(r), al.encode(q), rec.alignment)
        else:
            priced = price_alignment(cfg, al.encode(r), al.encode(q), rec.alignment)
        if priced != cost:
            raise AssertionError(f"batch flanked={flanked}: a record reprices to {priced}, "
                                 f"reported {cost}")
        costs.append(cost)
    names = ["sweep_flanked_pairs" if flanked else "sweep_flankless_pairs", "module_scan_pairs",
             "module_scan_diag"]
    for name in names:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"batch flanked={flanked}: kernel {name} was not launched")
    singles = {}
    lengths = [len(r) + len(q) for r, q in pairs]
    for i in (int(np.argmin(lengths)), int(np.argmax(lengths))):
        r, q = pairs[i]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        got = tsalign_tpu_torch.Aligner(costs=cfg, device=DEV).align(r, q)
        torch.cuda.synchronize()
        singles[i] = dict(n_r=len(r), n_q=len(q), cost=got.stats()["cost"],
                          wall_s=time.monotonic() - t0)
        if got.stats()["cost"] != costs[i]:
            raise AssertionError(f"batch flanked={flanked}: pair {i} costs {costs[i]} in the "
                                 f"batch and {got.stats()['cost']} alone")
    say(7, batch="flanked" if flanked else "flankless", pairs=len(pairs),
        n_r=[len(r) for r, _ in pairs], n_q=[len(q) for _, q in pairs], costs=costs,
        rounds=[rounds[i] for i in range(len(pairs))],
        redone_by_the_single_pair_engine=[i for i in range(len(pairs)) if redone(i)], wall_s=wall,
        wall_s_a_pair=wall / len(pairs), repriced=True, kernel_device_ms=kernel_ms,
        kernel_device_share=sum(kernel_ms.values()) / 1e3 / wall, launches=counts,
        control_reads_per_round=per_round, largest_control_read=largest, peak_mem_bytes=peak,
        single_pair=singles)
    return counts, dict(records=records, rounds=[rounds[i] for i in range(len(pairs))],
                        wall_s=wall, kernel_device_ms=kernel_ms, launches=counts,
                        control_reads_per_round=per_round, largest_control_read=largest,
                        peak_mem_bytes=peak)


def phase7_fixture():
    """The batch fixture's eight pairs (60-128 bp, two buckets) through
    `align_pairs` on the card: cost and CIGAR equal the JAX package's batched
    engine's (recorded on the CPU)."""
    al = get_alphabet("dna-n")
    with open(BATCH_FIXTURE) as f:
        fixture = json.load(f)["pairs"]
    pairs = [(p["reference"], p["query"]) for p in fixture]
    records = align_pairs(TemplateSwitchConfig.default(al), pairs,
                          names=[(p["name"], p["name"]) for p in fixture], device=DEV)
    for p, rec in zip(fixture, records):
        if rec.result.cost != p["cost"] or rec.cigar() != p["cigar"]:
            raise AssertionError(f"batch fixture {p['name']}: port {rec.result.cost} "
                                 f"{rec.cigar()} != JAX {p['cost']} {p['cigar']}")
    say(7, batch_fixture=[p["name"] for p in fixture], costs=[p["cost"] for p in fixture],
        equal=True)


def phase8_chain():
    """Chained mode at the reference's scale: the CHAIN_LENGTH construction
    through ``tsalign_tpu_torch.chain_align(..., device="cuda")`` under the
    narrow configuration.  The cost must equal the constructed optimum, the
    alignment reprice to it with one template switch a planted stretch, the
    batched engine's kernels launch, and no window go to the numpy engine.
    Returns the launches, the meter (`ChainMeter`) and the CIGAR."""
    cfg = chain_config()
    ref, qry, expected, planted = chain_construction(CHAIN_LENGTH)
    _build.launches.clear()
    _build.kernel_events = []
    with ChainMeter() as meter:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = tsalign_tpu_torch.chain_align(cfg, ref, qry, target_segment=1024, device=DEV)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    kernel_ms = _build.kernel_ms()
    _build.kernel_events = None
    counts = dict(_build.launches)
    if res.cost != expected:
        raise AssertionError(f"chain: cost {res.cost}, constructed optimum {expected}")
    priced = price_alignment(cfg, ref, qry, res.alignment)
    if priced != res.cost:
        raise AssertionError(f"chain: the alignment reprices to {priced}, reported {res.cost}")
    entrances = sum(1 for _, t in res.alignment.entries if isinstance(t, TemplateSwitchEntrance))
    if entrances != planted:
        raise AssertionError(f"chain: {entrances} template switches, {planted} planted")
    for name in ("sweep_flankless_pairs", "module_scan_pairs", "module_scan_diag"):
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"chain: kernel {name} was not launched")
    if res.numpy_fallbacks:
        raise AssertionError(f"chain: {res.numpy_fallbacks} windows went to the numpy engine")
    say(8, chain=CHAIN_LENGTH, cost=res.cost, expected=expected, repriced=True,
        template_switches=entrances, segments=res.segments, anchors=res.anchors,
        anchors_native=res.anchors_native, cuts_rejoined=res.cuts_rejoined,
        numpy_fallbacks=res.numpy_fallbacks, launches=counts, kernel_device_ms=kernel_ms,
        kernel_device_share=sum(kernel_ms.values()) / 1e3 / wall, **meter.summary(wall))
    return counts, meter, res.alignment.cigar()


def phase8_kernels(meter):
    """The batched engine's kernels against their plain versions at the
    largest launch the chain made of each (its pair count and shapes, read by
    the meter), on seeded noise (the sweep's scratch buffers full of noise)."""
    gen = torch.Generator().manual_seed(8)
    if "sweep_flankless" not in meter.shapes or "module_scan" not in meter.shapes:
        raise AssertionError("chain: no sweep or module-scan launch was recorded")
    (P, n, Wq), *_ = meter.shapes["sweep_flankless"][0]
    sets = [sweep_inputs(gen, n, Wq) for _ in range(P)]
    sets = [[a[0], a[1], negate_some(a[2]), a[3], a[4]] for a in sets]
    stacked = [torch.stack(ts) for ts in zip(*sets)]
    wants = [sweep_flankless_torch(*ts) for ts in sets]
    for run in range(3):
        scratch_noise(n, Wq, 1, P)
        got = sweep_flankless(*stacked)
        for z in range(P):
            compare("sweep_flankless_pairs", got[z], wants[z], f"chain pair {z} run {run}")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    [sweep_flankless_torch(*ts) for ts in sets]
    torch.cuda.synchronize()
    plain_ms = (time.monotonic() - t0) * 1e3
    n_bytes = sum(nbytes(*ts) + nbytes(ts[2]) for ts in sets)
    bound_ms, bound_by = bound(n_bytes, P * n * Wq * SWEEP_OPS_PER_CELL, n + Wq - 1)
    say(8, kernel="sweep_flankless_pairs", pairs=P, shape=[n, 3, Wq], equal=True,
        scratch_holds_noise=True, ms=cuda_ms(lambda: sweep_flankless(*stacked), 10),
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    (P, NB, C, W), _, _, _, (_, L, _) = meter.shapes["module_scan"][0][:5]
    sets = [module_inputs(gen, NB, C, W, L) for _ in range(P)]
    stacked = [torch.stack(ts) for ts in zip(*sets)]
    skip_from = max(scan_skip_from(ts, True) for ts in sets)
    for fwd in (True, False):
        kw = dict(fwd=fwd, allow_sdel=True)
        got = module_scan(*stacked, **kw)
        got_skip = module_scan(*stacked, **kw, skip_from=skip_from)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        wants = [module_scan_torch(*ts, **kw) for ts in sets]
        torch.cuda.synchronize()
        plain_ms = (time.monotonic() - t0) * 1e3
        for z in range(P):
            compare("module_scan_pairs", got[z], wants[z], f"chain pair {z} fwd={fwd} exact")
            compare("module_scan_pairs", got_skip[z], wants[z],
                    f"chain pair {z} fwd={fwd} skipping", mod_inf=True)
        bound_ms, bound_by, live, _ = module_scan_bound(
            *stacked, allow_sdel=True, B_plain=torch.stack(wants), skip_from=skip_from)
        say(8, kernel="module_scan_pairs", pairs=P, NB=NB, C=C, W=W, L=L, fwd=fwd, equal=True,
            equal_mod_inf_skipping=True,
            ms=cuda_ms(lambda: module_scan(*stacked, **kw, skip_from=skip_from), 10),
            exact_ms=cuda_ms(lambda: module_scan(*stacked, **kw), 10), plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, live_share=live)
    (P, NB, W), _, _, _, (_, L, _) = meter.shapes["module_scan_diag"][0][:5]
    sets = []
    for _ in range(P):
        seedT, *rest = module_inputs(gen, NB, NB, W, L)
        sets.append([seedT[torch.arange(NB), torch.arange(NB)].contiguous(), *rest])
    stacked = [torch.stack(ts) for ts in zip(*sets)]
    for fwd in (True, False):
        kw = dict(fwd=fwd, allow_sdel=True)
        got = module_scan_diag(*stacked, **kw)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        wants = [module_scan_torch(*ts, **kw) for ts in sets]
        torch.cuda.synchronize()
        plain_ms = (time.monotonic() - t0) * 1e3
        for z in range(P):
            compare("module_scan_diag", got[z], wants[z], f"chain pair {z} fwd={fwd}")
        work = [module_scan_work(*ts, allow_sdel=True) for ts in sets]
        bound_ms, bound_by = bound(sum(w[0] for w in work), sum(w[1] for w in work))
        say(8, kernel="module_scan_diag", pairs=P, NB=NB, W=W, L=L, fwd=fwd, equal=True,
            ms=cuda_ms(lambda: module_scan_diag(*stacked, **kw), 10), plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by)


def phase8_fixture():
    """The chain fixture's three pairs on the card: cost, CIGAR, segments,
    anchors and rejoined cuts equal the JAX package's (recorded on the CPU)."""
    with open(CHAIN_FIXTURE) as f:
        fixture = json.load(f)["pairs"]
    for p in fixture:
        al = get_alphabet(p["alphabet"])
        cfg = (chain_config() if p["config"] == "narrow"
               else TemplateSwitchConfig.parse_plain(p["config"], al))
        res = tsalign_tpu_torch.chain_align(
            cfg, al.encode(p["reference"]), al.encode(p["query"]),
            target_segment=p["target_segment"], device=DEV)
        got = (res.cost, res.alignment.cigar(), res.segments, res.anchors, res.cuts_rejoined)
        want = (p["cost"], p["cigar"], p["segments"], p["anchors"], p["cuts_rejoined"])
        if got != want:
            raise AssertionError(f"chain fixture {p['name']}: port {got[:1] + got[2:]} "
                                 f"!= JAX {want[:1] + want[2:]} (or the CIGARs differ)")
    say(8, chain_fixture=[p["name"] for p in fixture], costs=[p["cost"] for p in fixture],
        equal=True)


def record_lines(text):
    """A TOML record without its wall-time lines."""
    return [line for line in text.splitlines()
            if not line.startswith(("duration_seconds", "runtime"))]


def run_cli(step, argv):
    """One run of the port's command line in this process: its printed lines,
    the launches it made (counts set to 0 just before), the kernels' device
    ms by CUDA events and its wall."""
    from tsalign_tpu_torch.cli import main as cli_main

    _build.launches.clear()
    _build.kernel_events = []
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    kernel_ms = _build.kernel_ms()
    _build.kernel_events = None
    if rc != 0:
        raise AssertionError(f"cli {step}: {argv[0]} exited {rc}: {out.getvalue()}")
    return out.getvalue(), dict(_build.launches), kernel_ms, wall


def printed_cost(step, text):
    costs = [line.split()[1] for line in text.splitlines() if line.startswith("cost: ")]
    if len(costs) != 1:
        raise AssertionError(f"cli {step}: no single cost line in {text!r}")
    return int(costs[0])


def cli_align_main_pair(step, d, argv, facade_record, kernels):
    """Align one main pair through the command line; its record must equal
    the facade's (phase 5 or 6) and the kernels must launch."""
    out_path = os.path.join(d, f"{step}.toml")
    text, counts, kernel_ms, wall = run_cli(step, argv + ["-o", out_path])
    with open(out_path) as f:
        record = f.read()
    if record_lines(record) != record_lines(facade_record):
        raise AssertionError(f"cli {step}: the record differs from the facade's")
    for name in kernels:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"cli {step}: kernel {name} was not launched")
    say(9, step=step, wall_s=wall, cost=printed_cost(step, text), record_equal=True,
        launches=counts, kernel_device_ms=kernel_ms)
    return out_path, counts


def write_fasta(path, *records):
    with open(path, "w") as f:
        f.write("".join(f">{name}\n{seq}\n" for name, seq in records))


def phase9(main_pair, flanked_pair, chain_cigar):
    """The command line on the card (`tsalign_tpu_torch.cli.main`), in a
    temporary directory: the two main pairs against the facade's records of
    phases 5 and 6, chained mode at CHAIN_LENGTH through `preprocess` and its
    cache, `show` on the three records, `--profile`.  Returns the launches
    of each aligning run."""
    al = get_alphabet("dna-n")
    launches = {}
    with tempfile.TemporaryDirectory() as d:
        # (a) the flankless main pair, without --device: the default is the card
        r, q, record = main_pair
        ref_fa, qry_fa = os.path.join(d, "ref.fa"), os.path.join(d, "qry.fa")
        write_fasta(ref_fa, (MAIN_NAMES[0], r))
        write_fasta(qry_fa, (MAIN_NAMES[1], q))
        flankless, launches["flankless"] = cli_align_main_pair(
            "a_flankless", d, ["align", "-r", ref_fa, "-q", qry_fa], record,
            ("sweep_flankless", "module_scan", "module_scan_diag"))

        # (b) the flanked main pair, its config as display() text
        r, q, record = flanked_pair
        os.makedirs(os.path.join(d, "cfg"))
        with open(os.path.join(d, "cfg", "config.tsa"), "w") as f:
            f.write(flanked_default(al).display())
        pair_fa = os.path.join(d, "pair.fa")
        write_fasta(pair_fa, (MAIN_NAMES[0], r), (MAIN_NAMES[1], q))
        flanked, launches["flanked"] = cli_align_main_pair(
            "b_flanked", d, ["align", "-p", pair_fa, "-c", os.path.join(d, "cfg"),
                             "--device", "cuda"], record, ("sweep_flanked", "module_scan"))

        # (c) chained mode at the reference's scale, its plan from the cache.
        # The command line segments at chain_align's default of 512 where phase
        # 8 passes 1024: more windows and launches, the same CIGAR.
        from tsalign_tpu_torch.chain.plan import infer_max_n

        cfg = chain_config()
        cfg_dir, cache = os.path.join(d, "chaincfg"), os.path.join(d, "cache")
        os.makedirs(cfg_dir)
        with open(os.path.join(cfg_dir, "config.tsa"), "w") as f:
            f.write(cfg.display())
        max_n = infer_max_n(CHAIN_LENGTH, CHAIN_LENGTH)
        text, _, _, wall = run_cli("c_preprocess", ["preprocess", "-c", cfg_dir,
                                                    "--cache-directory", cache,
                                                    "--max-n", str(max_n)])
        say(9, step="c_preprocess", wall_s=wall, max_n=max_n, printed=text.strip(),
            plan_files=len(os.listdir(cache)))
        ref, qry, expected, planted = chain_construction(CHAIN_LENGTH)
        chain_ref, chain_qry = os.path.join(d, "chain_ref.fa"), os.path.join(d, "chain_qry.fa")
        write_fasta(chain_ref, ("reference chain", al.decode(ref)))
        write_fasta(chain_qry, ("query chain", al.decode(qry)))
        chain = os.path.join(d, "chain.toml")
        text, counts, kernel_ms, wall = run_cli(
            "c_chain", ["align", "-r", chain_ref, "-q", chain_qry, "-c", cfg_dir,
                        "--alignment-method", "a-star-chain-ts", "--cache-directory", cache,
                        "--force-no-preprocessing", "-o", chain])
        launches["chain"] = counts
        cost = printed_cost("c_chain", text)
        t0 = time.monotonic()
        with open(chain) as f:
            parsed = AlignmentResult.from_toml(f.read())
        parse_s = time.monotonic() - t0
        priced = price_alignment(cfg, ref, qry, parsed.alignment)
        if not cost == int(parsed.cost) == priced == expected:
            raise AssertionError(f"cli chain: printed {cost}, record {parsed.cost}, repriced "
                                 f"{priced}, constructed optimum {expected}")
        if parsed.alignment.cigar() != chain_cigar:
            raise AssertionError("cli chain: the CIGAR differs from phase 8's chain_align")
        for name in ("sweep_flankless_pairs", "module_scan_pairs", "module_scan_diag"):
            if counts.get(name, 0) <= 0:
                raise AssertionError(f"cli chain: kernel {name} was not launched")
        say(9, step="c_chain", wall_s=wall, cost=cost, expected=expected, repriced=priced,
            cigar_equal=True, record_bytes=os.path.getsize(chain), record_parse_s=parse_s,
            launches=counts, kernel_device_ms=kernel_ms)

        # (d) show on the three records, and -n with a no-TS record
        nots = os.path.join(d, "nots.toml")
        text, _, _, wall = run_cli("d_no_ts", ["align", "-r", ref_fa, "-q", qry_fa, "--no-ts",
                                               "-o", nots])
        say(9, step="d_no_ts", wall_s=wall, cost=printed_cost("d_no_ts", text))
        for name, path, extra in (("flankless", flankless, ["-n", nots]),
                                  ("flanked", flanked, []), ("chain", chain, [])):
            svg = os.path.join(d, f"{name}.svg")
            text, _, _, wall = run_cli(f"d_show_{name}", ["show", "-i", path, "-s", svg,
                                                          "-a", "-c", "-e"] + extra)
            if "Showing template switch" not in text or (extra and "No-ts CIGAR" not in text):
                raise AssertionError(f"cli show {name}: no template switch shown")
            t0 = time.monotonic()
            with open(svg) as f:
                root = xml.dom.minidom.parse(f).documentElement.tagName
            if root != "svg":
                raise AssertionError(f"cli show {name}: the SVG's root is {root}")
            say(9, step=f"d_show_{name}", wall_s=wall, svg_parse_s=time.monotonic() - t0,
                svg_bytes=os.path.getsize(svg), switches_shown=text.count("Showing template"))

        # (e) --profile on the 60 bp fixture pair
        with open(FIXTURE) as f:
            p = json.load(f)["pairs"][0]
        small = os.path.join(d, "small.fa")
        write_fasta(small, ("reference", p["reference"]), ("query", p["query"]))
        prof = os.path.join(d, "prof")
        text, counts, kernel_ms, wall = run_cli("e_profile", ["align", "-p", small,
                                                              "--profile", prof])
        traces = [n for n in os.listdir(prof) if n.endswith(".pt.trace.json")]
        if len(traces) != 1:
            raise AssertionError(f"cli profile: trace files {os.listdir(prof)}")
        with open(os.path.join(prof, traces[0])) as f:
            trace = f.read()
        named = {k: k in trace for k in ("sweep_kernel", "module_scan_kernel")}
        if not all(named.values()) or printed_cost("e_profile", text) != p["cost"]:
            raise AssertionError(f"cli profile: kernels named {named}, {text!r}")
        say(9, step="e_profile", wall_s=wall, cost=p["cost"], trace_bytes=len(trace),
            kernels_named=named, launches=counts, kernel_device_ms=kernel_ms)
    return launches


class RouteMeter:
    """What one run through the rounds loop did: every engine pass (its
    rounds and route log), the assembly calls, the launches (counts set to 0
    on entry) and the kernels' device ms by CUDA events."""

    def __enter__(self):
        from tsalign_tpu_torch.ops import modules

        self.engines, self.assembly_calls = [], 0
        self._undo = []

        def wrap(owner, attr, before):
            inner = getattr(owner, attr)

            def counted(*a, **kw):
                out = inner(*a, **kw)
                before(a, out)
                return out

            setattr(owner, attr, counted)
            self._undo.append((owner, attr, inner))

        wrap(TorchAligner, "align", lambda a, out: self.engines.append((a[0], out.rounds)))
        wrap(modules, "assembly_torch",
             lambda a, out: setattr(self, "assembly_calls", self.assembly_calls + 1))
        _build.launches.clear()
        _build.kernel_events = []
        torch.cuda.synchronize()
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.wall = time.monotonic() - self.t0
        self.kernel_ms = _build.kernel_ms()
        _build.kernel_events = None
        self.launches = dict(_build.launches)
        for owner, attr, inner in reversed(self._undo):
            setattr(owner, attr, inner)
        return False

    def summary(self):
        log = [e for eng, _ in self.engines for e in eng.route_log]
        compact = [e for e in log if e["route"] == "compact"]
        return dict(
            wall_s=self.wall, engine_passes=len(self.engines),
            rounds=[r for _, r in self.engines],
            module_scan_launches={k: v for k, v in self.launches.items()
                                  if k.startswith("module_scan")},
            assembly_calls=self.assembly_calls, compact_launches=len(compact),
            chunked_launches=sum(1 for e in log if e["route"] == "chunked"),
            compact_mean_live_cols=(sum(len(e["e_live"]) for e in compact) / len(compact)
                                    if compact else None),
            compact_mean_Kb=sum(e["Kb"] for e in compact) / len(compact) if compact else None,
            kernel_device_ms=self.kernel_ms, launches=self.launches)


def cold_memos():
    """Forget every content-keyed memo of the engines (kind tables,
    same-sequence scans, remaining bounds, stacked sweep tables)."""
    from tsalign_tpu_torch import engine
    from tsalign_tpu_torch.parallel import batch_ts

    for memo in (engine._KINDS_MEMO, engine._LB_MEMO, batch_ts._BATCH_BOUNDS_MEMO,
                 batch_ts._BATCH_KINDS_MEMO, batch_ts._BATCH_ARRAYS_MEMO):
        memo.clear()


def compact_against_chunked(eng, A, kinds, best, device):
    """Every kind that the engine's rule sends compact on the entry field A:
    its reentry field by both routes (`_launch_compact` and the chunks that
    cover its live columns), which must be equal; and their launch counts."""
    from tsalign_tpu_torch import engine
    from tsalign_tpu_torch.ops.common import full_inf
    from tsalign_tpu_torch.ops.modules import fold_kind_cells, kind_all_chunks

    AS = eng._entry_bound(A, best)
    shape = (eng.n_r + 1, eng.n_q + 1)
    R_compact, R_chunked, rows = full_inf(shape, device), full_inf(shape, device), []
    for km in kinds:
        spec = km.spec
        A_mod = A if spec.pk == 0 else A.T
        route = eng._route(km, A_mod, AS, best)
        if route is None or route[0] != "compact":
            continue
        _, e_live, Kb = route
        engine._COMPACT_ROUTE = False
        try:
            bases = eng._route(km, A_mod, AS, best)[1]
        finally:
            engine._COMPACT_ROUTE = True
        A_dev = torch.from_numpy(np.ascontiguousarray(A_mod)).to(device)
        PAD = max(0, -km.s_lo)
        width = PAD + spec.n_anti + 1 + max(0, km.chunk - 1 + km.s_hi)
        _build.launches.clear()
        slab_c = eng._launch_compact(km, A_dev, e_live, Kb)
        launches_c = sum(_build.launches.values())
        _build.launches.clear()
        (slab_k,) = kind_all_chunks([km], A_dev[None], np.asarray([bases]), PAD, width)
        launches_k = sum(_build.launches.values())
        fold = dict(PAD=PAD, n_anti=spec.n_anti, transpose=spec.pk == 1)
        Rc = fold_kind_cells(full_inf(shape, device), slab_c, spec.n_anti_real, **fold)
        Rk = fold_kind_cells(full_inf(shape, device), slab_k, spec.n_anti_real, **fold)
        if not torch.equal(Rc, Rk):
            raise AssertionError(f"routes: kind {(spec.pk, spec.sk, spec.dk)}: the compact "
                                 "route's reentry field differs from the chunked route's")
        R_compact = torch.minimum(R_compact, Rc)
        R_chunked = torch.minimum(R_chunked, Rk)
        # (entry row, column) problems whose entry value is infinite: dead at
        # level 0 whatever the kind's tables
        cols = torch.from_numpy(e_live).to(device)
        dead_compact = float((A_dev.index_select(1, cols) >= DEV_INF_THRESH).float().mean())
        covered = torch.cat([torch.arange(b, b + km.chunk) for b in bases if b >= 0]).to(device)
        dead_chunked = float((A_dev.index_select(1, covered) >= DEV_INF_THRESH).float().mean())
        rows.append(dict(kind=[spec.pk, spec.sk, spec.dk], live_cols=int(e_live.size), Kb=Kb,
                         chunks=sum(1 for b in bases if b >= 0), launches_compact=launches_c,
                         launches_chunked=launches_k, dead_at_level_0_compact=dead_compact,
                         dead_at_level_0_chunked=dead_chunked))
    if not torch.equal(R_compact, R_chunked):
        raise AssertionError("routes: the folded reentry fields differ")
    return rows


def first_compact_round(step, eng, calls, device):
    """Hold the two routes against each other (`compact_against_chunked`) at
    the first reentry round after round 1 in which the engine `eng` sent a
    kind compact; `calls` are its reentry calls (A, kinds, best) in order.
    Returns that round's (A, kinds, best), None if no such round."""
    rounds = sorted({e["round"] for e in eng.route_log if e["route"] == "compact"})
    later = [k for k in rounds if k >= 2]
    if not later:
        say(10, step=step, compact_rounds=rounds, route_log=eng.route_log)
        return None
    k = later[0]
    A, kinds, best = calls[k - 1]
    rows = compact_against_chunked(eng, A, kinds, best, device)
    say(10, step=step, n_r=eng.n_r, n_q=eng.n_q, chunk=eng.chunk, round=k,
        compact_rounds=rounds, equal=True, kinds=rows,
        routes_by_round=[[e["round"], e["kind"], e["route"], e.get("Kb"),
                          len(e.get("e_live", ())), e.get("chunks")] for e in eng.route_log])
    return A, kinds, best


@contextlib.contextmanager
def reentry_calls():
    """Record every engine's reentry calls: {engine: [(A, kinds, best)]}."""
    calls = collections.defaultdict(list)
    inner = TorchAligner._reentry

    def recording(eng, A, kinds, best=INF):
        calls[eng].append((A.copy(), kinds, best))
        return inner(eng, A, kinds, best=best)

    TorchAligner._reentry = recording
    try:
        yield calls
    finally:
        TorchAligner._reentry = inner


def phase10_compact_pipeline():
    """(a), small pair: at a 160 x 150 pair with chunk 16 (where the rule
    sends kinds compact early), the two routes' reentry fields on the card at
    its first compact round after round 1, then `kind_sel_chunks` on the card
    against its plain run on the CPU for a cross and a same-sequence kind
    (the main pair's check runs inside (b))."""
    from tsalign_tpu_torch.ops.modules import kind_sel_chunks

    al = get_alphabet("dna-n")
    ref, qry = planted_pair(np.random.default_rng(160), 160, 24, 3, True, q_len=150)
    K = 512  # the K-scaled tie-break's K at 160 + 150
    eng = TorchAligner(TemplateSwitchConfig.default(al).scaled_for_length_tiebreak(K),
                       al.encode(ref), al.encode(qry), device=DEV, chunk=16,
                       keep_fields=False, fused=False)
    with reentry_calls() as calls:
        eng.align()
    picked = first_compact_round("a_small_pair", eng, calls[eng], torch.device(DEV))
    if picked is None:
        raise AssertionError("routes: no kind of the small pair went compact after round 1")
    A, kinds, best = picked
    AS = eng._entry_bound(A, best)
    chosen = {}
    for km in kinds:
        A_mod = A if km.spec.pk == 0 else A.T
        e_live = np.nonzero((AS if km.spec.pk == 0 else AS.T).min(axis=0) <= best)[0]
        if e_live.size and km.same_seq not in chosen:
            chosen[km.same_seq] = (km, A_mod, e_live)
    for same, (km, A_mod, e_live) in sorted(chosen.items()):
        Kb = km.chunk
        while Kb < e_live.size:
            Kb *= 2
        e_sel = np.zeros((1, Kb), np.int64)
        e_sel[0, : e_live.size] = e_live
        PAD = max(0, -km.s_lo)
        OUTW = PAD + km.spec.n_anti + 1 + max(0, km.s_hi)
        A_t = torch.from_numpy(np.ascontiguousarray(A_mod))[None]
        got = kind_sel_chunks([km], A_t.to(DEV), e_sel, PAD, OUTW)
        want = kind_sel_chunks([km], A_t, e_sel, PAD, OUTW)
        # the card's module scan runs its skipping mode: equal below 2^29
        if not equal_mod_inf(got, want.to(DEV)):
            raise AssertionError(f"routes: kind_sel_chunks on the card differs from the "
                                 f"CPU's (same_seq={same})")
        say(10, step="a_card_against_cpu", kind=[km.spec.pk, km.spec.sk, km.dk],
            same_seq=same, live_cols=int(e_live.size), Kb=Kb, equal_mod_inf=True,
            finite_cells=int((got < DEV_INF_THRESH).sum()))


def phase10_host_routes(main_pair):
    """(b) The host rounds loop on the flankless main pair through the
    facade, the chunked route (the private switch off) and the compact route
    in turns, chunked, compact, chunked, compact, each from cold memos: the
    records must be equal but for their wall lines.  The flanked pair's A/B
    is left out for the smoke's time.  In the first compact run, (a) at the
    main pair: the two routes' reentry fields on the card at the first
    engine pass's first compact round after round 1.  Returns the launches of
    the last run of each route and the compact run's record."""
    from tsalign_tpu_torch import engine

    name, cfg, r, q = main_pair
    launches, records = {}, []
    for run, compact in enumerate((False, True, False, True)):
        engine._COMPACT_ROUTE = compact
        cold_memos()
        try:
            with reentry_calls() as calls, RouteMeter() as meter:
                res = tsalign_tpu_torch.Aligner(costs=cfg, device=DEV, fused=False).align(
                    r, q, reference_name=MAIN_NAMES[0], query_name=MAIN_NAMES[1])
        finally:
            engine._COMPACT_ROUTE = True
        records.append(res.to_toml())
        route = "compact" if compact else "chunked"
        launches[f"routes_{route}"] = meter.launches
        say(10, step="b_host_loop", pair=name, route=route, cost=res.stats()["cost"],
            **meter.summary())
        if run == 1:
            eng = meter.engines[0][0]
            first_compact_round("a_main_pair", eng, calls[eng], torch.device(DEV))
    if len({tuple(record_lines(rec)) for rec in records}) != 1:
        raise AssertionError(f"routes {name}: the records differ between the routes")
    say(10, step="b_host_loop", pair=name, records_equal=True)
    return launches, records[-1]


# The record lines in which a run of the fused loop may differ from one of
# the host loop: the wall lines, and opened_nodes, the DP cells counted, whose
# formula for a fused run (``engine.TorchAligner._fused_delegate``, the JAX
# package's) counts one sweep more than the host loop runs where the rounds
# end by the no-sweep stop.
FUSED_MAY_DIFFER = {"duration_seconds", "runtime", "opened_nodes"}


def differing_keys(a: str, b: str) -> set:
    lines_a, lines_b = a.splitlines(), b.splitlines()
    if len(lines_a) != len(lines_b):
        raise AssertionError("the records differ in their number of lines")
    return {x.split("=")[0].strip() for x, y in zip(lines_a, lines_b) if x != y}


def control_reads_by_round():
    """{"loop:round": reads} of the fused loops since the list was cleared,
    and the largest read's elements."""
    from tsalign_tpu_torch.parallel import fused_rounds

    per_round = collections.Counter(f"{loop}:{k}" for loop, k, _ in fused_rounds.control_reads)
    return dict(per_round), max((n for *_, n in fused_rounds.control_reads), default=0)


def check_control_reads(per_round, largest, n_pairs, n_max, chunk=64):
    """At most two control reads a round, each at most the all-done flag and
    eight kinds' per-pair chunk liveness: no field crossed to the host."""
    if per_round and max(per_round.values()) > 2:
        raise AssertionError(f"fused: more than two control reads in a round: {per_round}")
    if largest > 1 + n_pairs * 8 * -(-(n_max + 1) // chunk):
        raise AssertionError(f"fused: a control read of {largest} elements")


def phase10_fused(main_pair, host_record, batch7):
    """(c) The fused rounds loop against the host loop: the flankless main
    pair through the facade's default (the single-pair delegation on the
    card) against (b)'s compact host run; then phase 7's flankless batch,
    which ran the fused loop (`align_pairs`' default on the card), against
    the same batch through the host loop (`fused=False`): equal records
    but for the wall lines, equal rounds.  At most two control reads a round
    of a loop, none of them field-sized."""
    from tsalign_tpu_torch.parallel import fused_rounds

    launches = {}
    name, cfg, r, q = main_pair
    cold_memos()
    fused_rounds.control_reads.clear()
    torch.cuda.reset_peak_memory_stats()
    with RouteMeter() as meter:
        res = tsalign_tpu_torch.Aligner(costs=cfg, device=DEV).align(
            r, q, reference_name=MAIN_NAMES[0], query_name=MAIN_NAMES[1])
    loops = [eng.loop for eng, _ in meter.engines]
    if "fused" not in loops:
        raise AssertionError(f"fused: the facade's default ran the loops {loops}")
    differ = differing_keys(res.to_toml(), host_record)
    if not differ <= FUSED_MAY_DIFFER:
        raise AssertionError(f"fused {name}: the record differs from the host loop's in {differ}")
    per_round, largest = control_reads_by_round()
    check_control_reads(per_round, largest, 1, max(len(r), len(q)))
    launches["routes_fused"] = meter.launches
    say(10, step="c_fused_single_pair", pair=name, loops=loops, cost=res.stats()["cost"],
        record_differs_in=sorted(differ), control_reads_per_round=per_round,
        largest_control_read=largest, peak_mem_bytes=torch.cuda.max_memory_allocated(),
        **meter.summary())

    check_control_reads(batch7["control_reads_per_round"], batch7["largest_control_read"],
                        len(batch7["records"]), 512)
    al = get_alphabet("dna-n")
    rounds = {}

    def on_batch(idx, bt):
        for i, x in zip(idx, bt.last_results):
            rounds[i] = x.rounds

    cold_memos()
    torch.cuda.reset_peak_memory_stats()
    with RouteMeter() as meter:
        records = align_pairs(TemplateSwitchConfig.default(al), batch_pairs(), device=DEV,
                              on_batch=on_batch, fused=False)
    host_rounds = [rounds[i] for i in range(len(records))]
    equal = ([record_lines(x.to_toml()) for x in records]
             == [record_lines(x.to_toml()) for x in batch7["records"]])
    say(10, step="c_batch", pairs=len(records), costs=[x.result.cost for x in records],
        rounds_host=host_rounds, rounds_fused=batch7["rounds"], records_equal=equal,
        fused_wall_s=batch7["wall_s"], host_wall_s=meter.wall,
        fused_kernel_device_ms=batch7["kernel_device_ms"],
        host_kernel_device_ms=meter.kernel_ms,
        fused_control_reads_per_round=batch7["control_reads_per_round"],
        fused_largest_control_read=batch7["largest_control_read"],
        fused_peak_mem_bytes=batch7["peak_mem_bytes"],
        host_peak_mem_bytes=torch.cuda.max_memory_allocated(),
        fused_launches=batch7["launches"], host_launches=meter.launches,
        host_assembly_calls=meter.assembly_calls)
    if not equal or host_rounds != batch7["rounds"]:
        raise AssertionError("fused batch: the records or rounds differ from the host loop's")
    return launches


def phase10_delegation():
    """(d) The delegation's conditions on the card: the facade with
    max_template_switches=1 and with prune_range runs the host loop, its
    default the fused loop (a 160 x 150 pair)."""
    al = get_alphabet("dna-n")
    r, q = planted_pair(np.random.default_rng(160), 160, 24, 3, True, q_len=150)
    cfg = TemplateSwitchConfig.default(al)
    for what, kw, want in (("default", {}, "fused"),
                           ("max_template_switches=1", dict(max_template_switches=1), "host"),
                           ("prune_range", dict(prune_range=True), "host")):
        with RouteMeter() as meter:
            res = tsalign_tpu_torch.Aligner(costs=cfg, device=DEV).align(r, q, **kw)
        loops = sorted({eng.loop for eng, _ in meter.engines})
        routes = sorted({e["route"] for eng, _ in meter.engines for e in eng.route_log})
        if loops != [want] or (want == "host") == ("fused" in routes):
            raise AssertionError(f"delegation {what}: loops {loops}, routes {routes}")
        say(10, step="d_delegation", case=what, loops=loops, routes=routes,
            cost=res.stats()["cost"], wall_s=meter.wall)


def phase10(r, q, batch7):
    """The routes of the rounds loop on the card, (a)-(d); `batch7` is
    phase 7's flankless batch (its fused loop's records, rounds and
    counts).  Returns the launches of the last chunked, compact and fused
    runs."""
    main_pair = ("flankless", TemplateSwitchConfig.default(get_alphabet("dna-n")), r, q)
    phase10_compact_pipeline()
    launches, host_record = phase10_host_routes(main_pair)
    launches.update(phase10_fused(main_pair, host_record, batch7))
    phase10_delegation()
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)")
    timings = {}
    for phase, fn in ((1, phase1), (2, phase2), (3, phase3), (4, phase4)):
        t0 = time.monotonic()
        timings.update(fn() or {})
        say(phase, phase_s=time.monotonic() - t0)
    t0 = time.monotonic()
    r, q, counts, record = phase5()
    timings.update(phase5_shapes(r, q))
    say(5, phase_s=time.monotonic() - t0)
    t0 = time.monotonic()
    fr, fq, flanked_counts, flanked_record = phase6()
    timings.update(phase6_shapes(fr, fq))
    say(6, phase_s=time.monotonic() - t0)
    t0 = time.monotonic()
    batch_counts, batch7 = phase7_batch(False)
    flanked_batch_counts, _ = phase7_batch(True)
    phase7_fixture()
    say(7, phase_s=time.monotonic() - t0)
    t0 = time.monotonic()
    chain_counts, meter, chain_cigar = phase8_chain()
    phase8_kernels(meter)
    phase8_fixture()
    say(8, phase_s=time.monotonic() - t0)
    t0 = time.monotonic()
    cli_counts = phase9((r, q, record), (fr, fq, flanked_record), chain_cigar)
    say(9, phase_s=time.monotonic() - t0)
    t0 = time.monotonic()
    route_counts = phase10(r, q, batch7)
    say(10, phase_s=time.monotonic() - t0)
    kernels = []
    for name, meta in KERNELS.items():
        if max_err[name] is None or name not in timings:
            raise AssertionError(f"{name}: not compared or not timed at the main shapes")
        ms, plain_ms, bound_ms, bound_by = timings[name]
        by_path = {"flankless": counts.get(name, 0), "flanked": flanked_counts.get(name, 0),
                   "batch": batch_counts.get(name, 0),
                   "flanked_batch": flanked_batch_counts.get(name, 0),
                   "chain": chain_counts.get(name, 0),
                   **{f"cli_{k}": v.get(name, 0) for k, v in cli_counts.items()},
                   **{k: v.get(name, 0) for k, v in route_counts.items()}}
        # the launches of the newest main path that runs the kernel: the
        # batches for the variants they launch, the single pairs for the rest
        # (a batch's redo pass launches those too)
        batched = name.endswith("_pairs") or name == "module_scan_diag"
        order = ("flanked_batch", "batch", "flanked", "flankless") if batched else (
            "flanked", "flankless")
        launches = next((by_path[k] for k in order if by_path[k]), 0)
        if launches <= 0 and name != "module_scan_wide":
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
