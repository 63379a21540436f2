#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card; takes no arguments

Phases, each ending with a line of its wall time (phase_s):
  1. the card (nvidia-smi name and power limit), torch/CUDA versions, and the
     build of the CUDA kernels from tsalign_tpu_torch/csrc;
  2. each kernel against its plain torch version on the card (torch.equal,
     tolerance 0) on seeded inputs holding DEV_INF and DEV_INF - 1, timed
     with CUDA events;
  3. three small planted-TSM pairs: the port's cost equals the Dijkstra
     oracle's (tsalign_tpu.oracle);
  4. the fixture pairs of tests/fixtures/torch_port_pairs.json: cost and CIGAR
     equal the JAX package's (recorded on the CPU);
  5. the main path at a real size: a seeded 500 x 420 pair under the default
     configuration through tsalign_tpu_torch.align(..., device="cuda"); both
     kernels must launch, and the alignment must reprice to the cost; then
     both kernels against their plain versions at the shapes that path
     launches: the root sweep, and two chunks of every cross kind in both
     directions.
Any failure raises, so the script exits nonzero before its last line.  The
last lines are the kernels' JSON record, the card's name and power limit,
and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# Python puts this script's directory first on sys.path, so both packages
# import from the checkout it sits in (and fail where it sits alone).
import tsalign_tpu_torch
from tsalign_tpu.alphabet import get_alphabet
from tsalign_tpu.config import TemplateSwitchConfig
from tsalign_tpu.oracle import OracleAligner
from tsalign_tpu.pricing import price_alignment
from tsalign_tpu_torch import _build
from tsalign_tpu_torch.engine import TorchAligner
from tsalign_tpu_torch.ops.common import DEV_INF, sat_add
from tsalign_tpu_torch.ops.module_scan import module_scan
from tsalign_tpu_torch.ops.modules import module_scan_torch
from tsalign_tpu_torch.ops.sweep import sweep_flankless, sweep_flankless_torch

DEV = "cuda"
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "tests", "fixtures", "torch_port_pairs.json")
KERNELS = {
    "sweep_flankless": {
        "route": "cuda",
        "source": "tsalign_tpu_torch/csrc/sweep_flankless.cu",
        "replaces": "tsalign_tpu/ops/pallas_sweep.py:238",
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


def planted_pair(rng, n, ts_len, snps, indel, q_len=None):
    """Random reference; the query copies its first `q_len` bases (all by
    default) with `snps` substitutions, an optional 1-bp deletion, and one
    planted reverse-complement stretch."""
    al = get_alphabet("dna")
    ref = rng.integers(0, 4, size=n).astype(np.int8)
    qry = list(ref)
    for _ in range(snps):
        k = int(rng.integers(0, n))
        qry[k] = (qry[k] + int(rng.integers(1, 4))) % 4
    a = int(rng.integers(4, (q_len or n) - ts_len - 4))
    comp = al.complement_array()
    qry[a : a + ts_len] = [int(comp[c]) for c in qry[a : a + ts_len]][::-1]
    if indel:
        del qry[int(rng.integers(0, len(qry)))]
    qry = qry[:q_len]
    return al.decode(ref), al.decode(np.array(qry, dtype=np.int8))


def phase3():
    for seed in range(3):
        rng = np.random.default_rng(300 + seed)
        n = int(rng.integers(40, 61))
        r, q = planted_pair(rng, n, int(rng.integers(8, 13)), 2, seed == 1)
        al = get_alphabet("dna-n")
        cfg = TemplateSwitchConfig.default(al)
        got = tsalign_tpu_torch.align(r, q, device=DEV)
        want, _ = OracleAligner(cfg, al.encode(r), al.encode(q)).align()
        if got.stats()["cost"] != want:
            raise AssertionError(f"pair {seed}: port cost {got.stats()['cost']} != oracle {want}")
        say(3, pair=seed, n_r=len(r), n_q=len(q), cost=want, equal=True)


def phase4():
    with open(FIXTURE) as f:
        fixture = json.load(f)
    for p in fixture["pairs"]:
        got = tsalign_tpu_torch.align(p["reference"], p["query"], device=DEV)
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
    for name in KERNELS:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"main pair: kernel {name} was not launched")
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
    sub_rows, dd, io, ie = eng._sweep._inputs_on(root.device)
    seeds = root[0].permute(1, 0, 2).contiguous()
    args = (sub_rows, dd, seeds, io, ie)
    compare("sweep_flankless", sweep_flankless(*args), sweep_flankless_torch(*args), "main shapes")
    timings = {"sweep_flankless": (cuda_ms(lambda: sweep_flankless(*args), 20),
                                   cuda_ms(lambda: sweep_flankless_torch(*args), 1))}
    say(5, kernel="sweep_flankless", shape=list(seeds.shape), equal=True,
        ms=timings["sweep_flankless"][0], plain_ms=timings["sweep_flankless"][1])

    E, best, _ = eng._sweep_summary(root)
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
            ms = cuda_ms(lambda: module_scan(*margs, **kw), 3)
            timings.setdefault("module_scan", (ms, plain_ms))
            NB, Cc, W = seedT.shape
            say(5, kernel="module_scan", kind=kind, e_base=e_base, NB=NB, C=Cc, W=W,
                L=km.L, fwd=kw["fwd"], allow_sdel=km.allow_sdel, equal=True,
                ms=ms, plain_ms=plain_ms)
    return timings


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
    kernels = []
    for name, meta in KERNELS.items():
        if max_err[name] is None or name not in timings:
            raise AssertionError(f"{name}: not compared or not timed at the main shapes")
        ms, plain_ms = timings[name]
        kernels.append(dict(name=name, **meta, launches=counts[name],
                            max_abs_err=max_err[name], ms=ms, plain_ms=plain_ms))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
