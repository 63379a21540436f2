"""Build and load the hand-written CUDA kernels of the port.

At first use, every ``csrc/*.cu`` is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library of its own with a plain C interface, one
``nvcc`` process per source and all of them started together, written to
``tsalign_tpu_torch/_build/`` (listed in ``.gitignore``) under the hash of the
source, and loaded with ``ctypes``.  A library whose hash matches is reused.
``ptxas -v`` runs with every build and its report (registers, spills and
shared memory of each kernel) is kept beside the library; `resources` reads it.
Each C entry point takes raw device pointers, ints and the CUDA stream, and
returns ``cudaGetLastError()`` after its launch; `check` raises on a nonzero
code.  Nothing here falls back: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import types
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "-split-compile=0",  # the module scan's 192 instantiations, on every core
]

# Kernel launches per wrapper name: each wrapper adds one where it launches
# its CUDA kernel, and nowhere else (the plain CPU path does not count).
launches: collections.Counter = collections.Counter()
# Device time of the launches: None (off), or a list that each wrapper
# extends with (name, start event, end event) around its launch, for a
# caller that wants the kernels' share of a run (chip_smoke.py phase 7).
kernel_events = None

_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C entry point -> (source stem, argument types)
_SIGNATURES = {
    # subs, ddrows, seeds, io, ie, out, skewed_in, skewed_out, n_rows, Wq, L, R,
    # climb, dd_stride, row_stride, plane_stride, warps, P, subs_pair, dd_pair,
    # seeds_pair, ins_pair, stream (both sweeps)
    "tsa_sweep": ("sweep", [_P] * 8 + [_I] * 6 + [_LL] * 2 + [_I] * 2 + [_LL] * 4 + [_P]),
    # n_rows, Wq, F, in_ints (out), out_ints (out)
    "tsa_sweep_scratch": ("sweep", [_I] * 3 + [_P] * 2),
    # out (clocks, value), n, stream
    "tsa_dpx_chain": ("sweep", [_P, _I, _P]),
    # seedT, lut, sdo, sde, pchar, pmask, io, ie, out,
    # P, NB, C, W, L, A, fwd, allow_sdel, skip_from, diag, stream
    "tsa_module_scan": ("module_scan", [_P] * 9 + [_I] * 10 + [_P]),
    # W, A, diag, K (out), T (out), G (out), bytes (out)
    "tsa_module_scan_plan": ("module_scan", [_I] * 3 + [_P] * 4),
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library():
    """The loaded kernels (one attribute per C entry point), built on first
    call: one nvcc process per source, run side by side."""
    global _lib
    if _lib is not None:
        return _lib
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    targets, procs = {}, []
    for src in sorted(CSRC.glob("*.cu")):
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + src.read_bytes() + headers)
        so = BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"
        targets[src.stem] = so
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".tmp{os.getpid()}")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), tmp, so))
    failures = []
    for proc, tmp, so in procs:  # wait for every process before raising
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}) on {so.name}:\n{stdout}\n{stderr}")
        else:
            so.with_suffix(".log").write_text(stderr)
            os.replace(tmp, so)
    if failures:
        raise RuntimeError("\n".join(failures))
    loaded = {stem: ctypes.CDLL(str(so)) for stem, so in targets.items()}
    lib = types.SimpleNamespace()
    for name, (stem, argtypes) in _SIGNATURES.items():
        fn = getattr(loaded[stem], name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        setattr(lib, name, fn)
    lib.paths = {stem: str(so) for stem, so in targets.items()}
    _lib = lib
    return lib


_PTXAS = re.compile(
    r"Compiling entry function '(?P<name>\w+)'.*?"
    r"(?P<stack>\d+) bytes stack frame, (?P<st>\d+) bytes spill stores, "
    r"(?P<ld>\d+) bytes spill loads.*?Used (?P<regs>\d+) registers", re.S)


def resources(stem: str) -> list:
    """What ``ptxas -v`` reported when ``csrc/<stem>.cu`` was built: one dict
    for each kernel with its mangled name, registers a thread, stack frame
    and spill bytes, in the order of the report."""
    log = Path(library().paths[stem]).with_suffix(".log").read_text()
    return [dict(name=m["name"], registers=int(m["regs"]), stack=int(m["stack"]),
                 spill_stores=int(m["st"]), spill_loads=int(m["ld"]))
            for m in _PTXAS.finditer(log)]


def timed(name: str, launch):
    """Run `launch()` (a C entry point's call; returns its code), between
    two CUDA events when `kernel_events` is a list."""
    if kernel_events is None:
        return launch()
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    code = launch()
    end.record()
    kernel_events.append((name, start, end))
    return code


def kernel_ms() -> dict:
    """Device milliseconds of the launches in `kernel_events`, per name."""
    import torch

    torch.cuda.synchronize()
    out = collections.Counter()
    for name, start, end in kernel_events or ():
        out[name] += start.elapsed_time(end)
    return dict(out)


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {code}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
