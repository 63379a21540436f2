#!/usr/bin/env python3
"""The port's sweep kernel beside the two kernels it replaced, on one CUDA card.

    python3 scripts/torch_port_sweep_probe.py --old-flankless FILE --old-flanked FILE
                                              [--tune] [--profile] [--reps N]

Runs from the root of a checkout, on a machine with one NVIDIA card and nvcc.
Every line it prints is `[probe] {json}`; the first holds the card's name and
power limit.

  * FILE and FILE are the sources of the row-serial kernels of an earlier
    commit (`git show <commit>:tsalign_tpu_torch/csrc/sweep_flankless.cu` and
    `.../sweep_flanked.cu`), with the C entry points `tsa_sweep_flankless`
    and `tsa_sweep_flanked`.  They are built beside the package's own
    `csrc/sweep.cu` with the package's nvcc flags.
  * At 501 x 3 x 421, 501 x 15 x 421, 1001 x 3 x 1001 and 1001 x 15 x 1001
    (rows x planes x columns; 15 planes are L = R = 2 with climb) on
    chip_smoke.py's seeded inputs: the earlier and the new kernel give equal
    outputs (torch.equal, row-major and plane-major), and they are timed with
    CUDA events in turns within this process: old, new, new, old.
  * Prints ptxas's registers and spills of every instantiation, the latency
    of one dependent DPX instruction and each shape's chain bound
    (chip_smoke.py's).
  * With `--tune`: the new kernel held to 1 .. 8 warps a block (one warp
    takes the super-tiles in turn; the launch itself takes a warp a
    super-tile, up to 8), at the same four shapes.
  * With `--profile`: the device time of each of a call's three kernels
    (`skew_in`, the wavefront, `skew_out`) by torch.profiler, in microseconds,
    and the host's time to queue a call and to allocate its scratch buffers
    (chip_smoke.py's `sweep_call_parts`).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from tsalign_tpu_torch import _build  # noqa: E402
from tsalign_tpu_torch.ops.common import I32  # noqa: E402
from tsalign_tpu_torch.ops.sweep import sweep_flanked, sweep_flankless  # noqa: E402

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SHAPES = ((501, 421), (1001, 1001))  # (n_rows, Wq): a 500 x 420 and a 1000 x 1000 pair
FLANKS = dict(L=2, R=2, climb=True)


def say(**numbers):
    print("[probe] " + json.dumps(numbers), flush=True)


def build_old(source: str, entry: str, argtypes):
    """C entry point `entry` of an earlier source, built with the package's
    nvcc flags into the package's build directory."""
    so = _build.BUILD_DIR / f"lib{entry}_earlier.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), source],
                   check=True, capture_output=True, text=True)
    fn = getattr(ctypes.CDLL(str(so)), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    say(earlier_source=source, entry=entry, build_s=time.monotonic() - t0)
    return fn


def old_flankless(fn):
    def run(sub_rows, dd, seeds, io, ie):
        n_rows, Wq = sub_rows.shape
        out = torch.empty((n_rows, 3, Wq), dtype=I32, device=seeds.device)
        _build.check(fn(sub_rows.data_ptr(), dd.data_ptr(), seeds.data_ptr(), io.data_ptr(),
                        ie.data_ptr(), out.data_ptr(), n_rows, Wq,
                        _build.stream_ptr(seeds.device)), "the earlier flankless sweep")
        return out
    return run


def old_flanked(fn):
    def run(subs, dd, seeds, io, ie, *, L, R, climb):
        _, n_rows, Wq = subs.shape
        out = torch.empty_strided(seeds.shape, seeds.stride(), dtype=I32, device=seeds.device)
        _build.check(fn(subs.data_ptr(), dd.data_ptr(), seeds.data_ptr(), io.data_ptr(),
                        ie.data_ptr(), out.data_ptr(), n_rows, Wq, L, R, int(climb),
                        seeds.stride(0), seeds.stride(1), _build.stream_ptr(seeds.device)),
                     "the earlier flanked sweep")
        return out
    return run


def cases(gen):
    """(name, new kernel, keyword arguments, inputs, bound) of the four shapes."""
    for n_rows, Wq in SHAPES:
        args = cs.sweep_inputs(gen, n_rows, Wq)
        yield "flankless", sweep_flankless, {}, args, cs.sweep_flankless_bound(*args)
        args = cs.flanked_sweep_inputs(gen, n_rows, Wq, 5)
        yield "flanked", sweep_flanked, FLANKS, args, cs.sweep_flanked_bound(*args, **FLANKS)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old-flankless", required=True)
    ap.add_argument("--old-flanked", required=True)
    ap.add_argument("--tune", action="store_true",
                    help="time the new kernel held to 1 .. 8 warps a block")
    ap.add_argument("--profile", action="store_true",
                    help="device time of each of a call's three kernels (torch.profiler)")
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    t0 = time.monotonic()
    _build.library()
    say(card=cs.card_line(), device=torch.cuda.get_device_name(0), torch=torch.__version__,
        cuda=torch.version.cuda, build_s=time.monotonic() - t0)
    cs.sweep_build_report()
    cs.measure_dpx_latency()
    old = {
        "flankless": old_flankless(build_old(a.old_flankless, "tsa_sweep_flankless",
                                             [_P] * 6 + [_I] * 2 + [_P])),
        "flanked": old_flanked(build_old(a.old_flanked, "tsa_sweep_flanked",
                                         [_P] * 6 + [_I] * 5 + [_LL] * 2 + [_P])),
    }
    gen = torch.Generator().manual_seed(5)
    for name, new, kw, args, (bound_ms, bound_by) in cases(gen):
        want = old[name](*args, **kw)
        equal = torch.equal(new(*args, **kw), want)
        planes = cs.plane_major(args[2])
        equal_planes = torch.equal(new(args[0], args[1], planes, args[3], args[4], **kw), want)
        row = dict(kernel=name, shape=list(args[2].shape), equal_earlier=equal,
                   equal_earlier_plane_major=equal_planes, bound_ms=bound_ms, bound_by=bound_by)
        if not (equal and equal_planes):
            say(**row)
            raise AssertionError(f"{name} {row['shape']}: new and earlier kernel differ")
        row["earlier_ms"] = [cs.cuda_ms(lambda: old[name](*args, **kw), a.reps)]
        row["ms"] = [cs.cuda_ms(lambda: new(*args, **kw), a.reps) for _ in range(2)]
        row["earlier_ms"].append(cs.cuda_ms(lambda: old[name](*args, **kw), a.reps))
        row["plane_major_ms"] = cs.cuda_ms(
            lambda: new(args[0], args[1], planes, args[3], args[4], **kw), a.reps)
        row["earlier_over_new"] = min(row["earlier_ms"]) / max(row["ms"])
        if a.profile:
            n_rows, planes_n, Wq = args[2].shape
            row.update(cs.sweep_call_parts(lambda: new(*args, **kw), n_rows, Wq, planes_n // 3,
                                           a.reps))
        say(**row)
        if a.tune:
            tuned = {}
            tables = (args[0], args[1], args[3], args[4])
            for warps in range(1, min(8, -(-args[2].shape[2] // 128)) + 1):
                held = lambda: cs.with_warps("sweep_" + name, warps, tables, args[2], kw)  # noqa: E731
                if not torch.equal(held(), want):
                    raise AssertionError(f"{name} warps={warps} differs")
                tuned[f"warps_{warps}"] = cs.cuda_ms(held, a.reps)
            say(kernel=name, shape=list(args[2].shape), held_to_warps_ms=tuned,
                best=min(tuned, key=tuned.get))


if __name__ == "__main__":
    main()
