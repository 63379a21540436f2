"""Build and load the hand-written CUDA kernels of the port.

At first use, every ``csrc/*.cu`` is compiled with ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, written to
``tsalign_tpu_torch/_build/`` (listed in ``.gitignore``) under the hash of the
sources, and loaded with ``ctypes``.  A library whose hash matches is reused.
Each C entry point takes raw device pointers, ints and the CUDA stream, and
returns ``cudaGetLastError()`` after its launch; `check` raises on a nonzero
code.  Nothing here falls back: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

# Kernel launches per wrapper name: each wrapper adds one where it launches
# its CUDA kernel, and nowhere else (the plain CPU path does not count).
launches: collections.Counter = collections.Counter()

_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # sub_rows, ddrows, seeds, io, ie, out, n_rows, Wq, stream
    "tsa_sweep_flankless": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    # seedT, lut, sdo, sde, pchar, pmask, io, ie, out,
    # NB, C, W, L, A, fwd, allow_sdel, stream
    "tsa_module_scan": [_P] * 9 + [_I] * 7 + [_P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library():
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    so = BUILD_DIR / f"libtsalign_kernels-{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
        cmd += [str(s) for s in sorted(CSRC.glob("*.cu"))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {code}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
