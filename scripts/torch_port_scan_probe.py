#!/usr/bin/env python3
"""Measurements of the port's module-scan kernel and main pairs on one CUDA card.

    python3 scripts/torch_port_scan_probe.py [--old-source FILE] [--define N=V]
                                             [--wide] [--sass-k K] [--breakdown] [--out DIR]

Runs from the root of a checkout, on a machine with one NVIDIA card and nvcc.
Every line it prints is `[probe] {json}`; the first holds the card's name and
power limit.

  * Always: builds the kernels, prints the module scan's build report
    (registers, stack and spill bytes of every instantiation, DPX
    instructions in the SASS; chip_smoke.module_scan_build_report) and
    writes the SASS of the instantiation with `--sass-k` offsets a lane
    (default 17, the main pairs') to `<out>/module_scan_K<k>.sass`.
  * Holds the kernel against the plain version at the chunks of the
    flankless main pair that chip_smoke.py uses (two chunks of each cross
    kind), in the exact mode (torch.equal) and the skipping mode
    (equal_mod_inf), and times both modes with CUDA events, with each mode's
    bound, the live share and the share of problems dead at level 0.
  * With `--old-source FILE`: FILE is the module-scan source of an earlier
    commit (`git show <commit>:tsalign_tpu_torch/csrc/module_scan.cu`), whose
    C entry point takes no skip_from.  It is built beside the package's own,
    held against the plain version, and timed in turns with the new kernel
    (old, new, new, old) on the same inputs in the same process.
  * With `--define NAME=VALUE` (repeatable): the package's own source built
    once more with these macros (TSA_WARPS, the warps a block) and timed in
    turns with the package's build, both modes.
  * With `--wide` (needs `--old-source`): the exact mode at a 1000 x 999
    pair's shapes (NB 1001, W 1100, L 1000) and at the widest module
    (W 2048), held against the earlier kernel and timed in turns with it.
  * With `--breakdown`: aligns both main pairs of chip_smoke.py (the
    flankless and the flanked 500 x 420 pair) on the host rounds loop
    (`fused=False`) twice each, once as they are
    and once with a torch.cuda.synchronize() around every layer, and prints
    each layer's exclusive seconds and calls.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import tsalign_tpu_torch  # noqa: E402
from tsalign_tpu_torch import _build, engine  # noqa: E402
from tsalign_tpu_torch.alphabet import get_alphabet  # noqa: E402
from tsalign_tpu_torch.config import TemplateSwitchConfig  # noqa: E402
from tsalign_tpu_torch.engine import TorchAligner  # noqa: E402
from tsalign_tpu_torch.ops import module_scan as scan_mod  # noqa: E402
from tsalign_tpu_torch.ops import modules  # noqa: E402
from tsalign_tpu_torch.ops.common import I32  # noqa: E402
from tsalign_tpu_torch.ops.module_scan import module_scan  # noqa: E402
from tsalign_tpu_torch.ops.modules import module_scan_torch  # noqa: E402


def say(**numbers):
    print("[probe] " + json.dumps(numbers), flush=True)


def build_old(source: str):
    """The earlier source's `tsa_module_scan` (no skip_from), built with the
    package's nvcc flags into the package's build directory."""
    so = _build.BUILD_DIR / "libmodule_scan_earlier.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), source],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(so)).tsa_module_scan
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    say(earlier_source=source, build_s=time.monotonic() - t0)

    def run(seedT, lut, sdo, sde, pchar, pmask, io, ie, *, fwd, allow_sdel):
        NB, C, W = seedT.shape
        L, A = pchar.shape[0], lut.shape[0]
        out = torch.empty((L + 1, NB, C), dtype=I32, device=seedT.device)
        _build.check(fn(*(t.data_ptr() for t in (seedT, lut, sdo, sde, pchar, pmask, io, ie)),
                        out.data_ptr(), NB, C, W, L, A, int(fwd), int(allow_sdel),
                        _build.stream_ptr(seedT.device)), "the earlier module_scan")
        return out

    return run


def build_variant(defines):
    """The package's own module-scan source built once more with `-D` flags
    (a tuning variant; same C interface), as a function like `module_scan`."""
    so = _build.BUILD_DIR / "libmodule_scan_variant.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *[f"-D{d}" for d in defines],
                    "-o", str(so), str(_build.CSRC / "module_scan.cu")],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(so)).tsa_module_scan
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(seedT, lut, sdo, sde, pchar, pmask, io, ie, *, fwd, allow_sdel, skip_from=0):
        NB, C, W = seedT.shape
        L, A = pchar.shape[0], lut.shape[0]
        out = torch.empty((L + 1, NB, C), dtype=I32, device=seedT.device)
        _build.check(fn(*(t.data_ptr() for t in (seedT, lut, sdo, sde, pchar, pmask, io, ie)),
                        out.data_ptr(), 1, NB, C, W, L, A, int(fwd), int(allow_sdel),
                        int(skip_from), 0, _build.stream_ptr(seedT.device)), "the variant")
        return out

    return run


def main_engine():
    """The engine of the flankless main pair's first pass (K-scaled
    tie-break config)."""
    rng = np.random.default_rng(500)
    r, q = cs.planted_pair(rng, 500, 40, 5, True, q_len=420)
    al = get_alphabet("dna-n")
    n = len(r) + len(q) + 2
    K = 1
    while K < n:
        K *= 2
    cfg = TemplateSwitchConfig.default(al)
    return TorchAligner(cfg.scaled_for_length_tiebreak(K), al.encode(r), al.encode(q),
                        device=cs.DEV)


def chunks(old, variant):
    eng = main_engine()
    for km, e_base, margs in cs.main_pair_chunks(eng, eng._root_seeds()):
        kw = dict(fwd=km.dk == 0, allow_sdel=km.allow_sdel)
        skip = dict(kw, skip_from=km.skip_from)
        want = module_scan_torch(*margs, **kw)
        cs.compare("module_scan", module_scan(*margs, **kw), want, "exact")
        cs.compare("module_scan", module_scan(*margs, **skip), want, "skipping", mod_inf=True)
        row = dict(kind=[km.spec.pk, km.spec.sk, km.dk], e_base=e_base,
                   shape=list(margs[0].shape), L=km.L, **kw, skip_from=km.skip_from)
        if old is not None:
            cs.compare("module_scan", old(*margs, **kw), want, "earlier kernel")
            row["earlier_ms"] = [cs.cuda_ms(lambda: old(*margs, **kw), 10)]
        row["exact_ms"] = [cs.cuda_ms(lambda: module_scan(*margs, **kw), 10) for _ in range(2)]
        row["skipping_ms"] = [cs.cuda_ms(lambda: module_scan(*margs, **skip), 10)
                              for _ in range(2)]
        if variant is not None:
            cs.compare("module_scan", variant(*margs, **kw), want, "variant exact")
            cs.compare("module_scan", variant(*margs, **skip), want, "variant skipping",
                       mod_inf=True)
            row["variant_exact_ms"] = [cs.cuda_ms(lambda: variant(*margs, **kw), 10),
                                       cs.cuda_ms(lambda: variant(*margs, **kw), 10)]
            row["variant_skipping_ms"] = [cs.cuda_ms(lambda: variant(*margs, **skip), 10),
                                          cs.cuda_ms(lambda: variant(*margs, **skip), 10)]
            row["exact_ms"].append(cs.cuda_ms(lambda: module_scan(*margs, **kw), 10))
            row["skipping_ms"].append(cs.cuda_ms(lambda: module_scan(*margs, **skip), 10))
        if old is not None:
            row["earlier_ms"].append(cs.cuda_ms(lambda: old(*margs, **kw), 10))
        row["exact_bound_ms"], row["exact_bound_by"], _, _ = cs.module_scan_bound(
            *margs, allow_sdel=km.allow_sdel)
        (row["skipping_bound_ms"], row["skipping_bound_by"], row["live_share"],
         row["dead_at_level_0_share"]) = cs.module_scan_bound(
            *margs, allow_sdel=km.allow_sdel, B_plain=want, skip_from=km.skip_from)
        say(**row)


def wide(old):
    """The exact mode at a 1000 x 999 pair's shapes and at the widest
    module, on chip_smoke.py's seeded inputs, against the earlier kernel
    (torch.equal; the plain version takes 40 s at these sizes) and in turns."""
    gen = torch.Generator().manual_seed(11)
    for NB, C, W, L in ((1001, 64, 1100, 1000), (501, 64, 2048, 500)):
        margs = cs.module_inputs(gen, NB, C, W, L)
        for fwd in (True, False):
            kw = dict(fwd=fwd, allow_sdel=True)
            skip = dict(kw, skip_from=cs.scan_skip_from(margs, True))
            got = module_scan(*margs, **kw)
            if not torch.equal(got, old(*margs, **kw)):
                raise AssertionError(f"W={W} fwd={fwd}: new and earlier kernel differ")
            if not cs.equal_mod_inf(module_scan(*margs, **skip), got):
                raise AssertionError(f"W={W} fwd={fwd}: skipping mode differs")
            say(synthetic=True, shape=[NB, C, W], L=L, fwd=fwd, equal_earlier=True,
                earlier_ms=cs.cuda_ms(lambda: old(*margs, **kw), 3),
                exact_ms=[cs.cuda_ms(lambda: module_scan(*margs, **kw), 3) for _ in range(2)],
                skipping_ms=cs.cuda_ms(lambda: module_scan(*margs, **skip), 3),
                earlier_ms_again=cs.cuda_ms(lambda: old(*margs, **kw), 3),
                exact_bound_ms=cs.module_scan_bound(*margs, allow_sdel=True)[0])


class Layers:
    """Exclusive wall seconds and calls of named layers, each entered and
    left through a torch.cuda.synchronize()."""

    def __init__(self):
        self.seconds = collections.Counter()
        self.calls = collections.Counter()
        self.stack = []
        self.undo = []

    def wrap(self, owner, attr, label):
        inner = getattr(owner, attr)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            now = time.monotonic()
            if self.stack:
                self.seconds[self.stack[-1][0]] += now - self.stack[-1][1]
            self.stack.append([label, now])
            try:
                return inner(*a, **kw)
            finally:
                torch.cuda.synchronize()
                now = time.monotonic()
                self.seconds[label] += now - self.stack.pop()[1]
                self.calls[label] += 1
                if self.stack:
                    self.stack[-1][1] = now

        setattr(owner, attr, timed)
        self.undo.append((owner, attr, inner))

    def restore(self):
        for owner, attr, inner in reversed(self.undo):
            setattr(owner, attr, inner)


def align_main(flanked: bool):
    rng = np.random.default_rng(500)
    r, q = cs.planted_pair(rng, 500, 40, 5, True, q_len=420, flank_snps=flanked)
    al = get_alphabet("dna-n")
    # every call starts cold: no kind tables, same-sequence scans or
    # remaining bound memoized from an earlier call of this process
    engine._KINDS_MEMO.clear()
    engine._LB_MEMO.clear()
    _build.launches.clear()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    # the host rounds loop, whose layers the breakdown wraps (the card's
    # default hands the pair to the fused loop of the batched engine)
    if flanked:
        res = tsalign_tpu_torch.Aligner(costs=cs.flanked_default(al), device=cs.DEV,
                                        fused=False).align(r, q)
    else:
        res = tsalign_tpu_torch.align(r, q, device=cs.DEV, fused=False)
    torch.cuda.synchronize()
    return time.monotonic() - t0, res.stats()["cost"], dict(_build.launches)


def breakdown():
    for flanked in (False, True):
        wall, cost, launches = align_main(flanked)
        say(pair="flanked" if flanked else "flankless", wrapped=False, wall_s=wall, cost=cost,
            launches=launches)
        layers = Layers()
        for owner, attr, label in (
                (scan_mod, "module_scan", "module-scan kernel (cross kinds)"),
                (modules, "assembly_torch", "assembly (plain torch)"),
                (modules, "kind_sel_chunks", "compact route glue (gathers, fold)"),
                (engine, "kind_sel_chunks", "compact route glue (gathers, fold)"),
                (modules.KindModule, "same_module", "same-sequence module scans"),
                (modules, "fold_kind_cells", "fold"),
                (engine, "fold_kind_cells", "fold"),
                (modules.KindModule, "tables", "kind tables to the card"),
                (TorchAligner, "_sweep_summary", "sweep kernel and summary"),
                (TorchAligner, "_remaining_bound", "remaining bound (host)"),
                (TorchAligner, "_can_improve_cells", "_can_improve_cells (host)"),
                (TorchAligner, "_pruned_entry_cells", "_pruned_entry_cells (host)"),
                (TorchAligner, "_build_kinds", "kind tables (host)"),
                (TorchAligner, "_route", "route and chunk bases (host)"),
                (TorchAligner, "_reentry", "reentry glue (seeds, slabs, copies)"),
                (TorchAligner, "align", "rounds loop glue"),
                (engine, "align_with_traceback", "traceback (host)")):
            layers.wrap(owner, attr, label)
        try:
            wall, cost, launches = align_main(flanked)
        finally:
            layers.restore()
        inside = sum(layers.seconds.values())
        rows = {k: [layers.seconds[k], layers.calls[k]] for k in
                sorted(layers.seconds, key=layers.seconds.get, reverse=True)}
        say(pair="flanked" if flanked else "flankless", wrapped=True, wall_s=wall, cost=cost,
            launches=launches, layer_seconds_calls=rows, facade_and_record_s=wall - inside)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old-source")
    ap.add_argument("--define", action="append", default=[],
                    help="NAME=VALUE for a variant of the package's source, timed in turns")
    ap.add_argument("--sass-k", type=int, default=17)
    ap.add_argument("--wide", action="store_true",
                    help="with --old-source: W = 1100 and W = 2048 against the earlier kernel")
    ap.add_argument("--breakdown", action="store_true")
    ap.add_argument("--out", default="scan_probe_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    t0 = time.monotonic()
    lib = _build.library()
    say(card=cs.card_line(), device=torch.cuda.get_device_name(0), torch=torch.__version__,
        cuda=torch.version.cuda, build_s=time.monotonic() - t0)
    cs.module_scan_build_report()
    os.makedirs(args.out, exist_ok=True)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    dump = subprocess.run([tool, "-sass", lib.paths["module_scan"]],
                          capture_output=True, text=True)
    parts = dump.stdout.split("\t\tFunction : ")
    # the one-warp cross-mode instantiation with K offsets a lane
    wanted = [p for p in parts if f"ILi{args.sass_k}ELb0ELb0E" in p.split("\n", 1)[0]]
    with open(os.path.join(args.out, f"module_scan_K{args.sass_k}.sass"), "w") as f:
        f.write("\n".join(wanted) or dump.stdout[-200000:] + dump.stderr)
    old = build_old(args.old_source) if args.old_source else None
    variant = build_variant(args.define) if args.define else None
    chunks(old, variant)
    if args.wide:
        if old is None:
            raise SystemExit("--wide needs --old-source")
        wide(old)
    if args.breakdown:
        breakdown()


if __name__ == "__main__":
    main()
