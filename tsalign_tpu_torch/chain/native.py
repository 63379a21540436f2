"""ctypes bridge to the native anchor kernel (csrc/anchors.cpp).

Builds the shared library on first use with g++ into
``tsalign_tpu_torch/_build/`` (listed in ``.gitignore``) under the hash of the
source, as ``_build.py`` does for the CUDA kernels; falls back to the numpy
implementation if the toolchain is unavailable.  Host code, not a device
kernel.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        src = os.path.join(here, "csrc", "anchors.cpp")
        if not os.path.exists(src):
            return None
        try:
            # Cache keyed by a source content hash (mtimes lie after a
            # fresh clone) and without -march=native so the binary stays
            # portable across the machines sharing the checkout.
            import hashlib

            with open(src, "rb") as f:
                digest = hashlib.sha1(f.read()).hexdigest()[:16]
            build = os.path.join(here, "_build")
            out = os.path.join(build, f"libtsanchors-{digest}.so")
            if not os.path.exists(out):
                os.makedirs(build, exist_ok=True)
                tmp = f"{out}.tmp{os.getpid()}"
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", src, "-o", tmp],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, out)
            lib = ctypes.CDLL(out)
        except (OSError, subprocess.CalledProcessError):
            return None
        lib.tsa_kmer_anchors.restype = ctypes.c_int64
        lib.tsa_kmer_anchors.argtypes = [
            ctypes.POINTER(ctypes.c_int8),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int8),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ]
        lib.tsa_free.argtypes = [ctypes.c_void_p]
        lib.tsa_chain.restype = ctypes.c_int64
        lib.tsa_chain.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        _LIB = lib
        return lib


def kmer_anchors_native(
    reference: np.ndarray, query: np.ndarray, k: int, max_out: int = 1 << 27
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """All k-mer co-occurrences (ref_pos, qry_pos), or None if the native
    library is unavailable or the result would exceed max_out."""
    lib = _build_and_load()
    if lib is None:
        return None
    ref = np.ascontiguousarray(reference, dtype=np.int8)
    qry = np.ascontiguousarray(query, dtype=np.int8)
    pri = ctypes.POINTER(ctypes.c_int64)()
    pqi = ctypes.POINTER(ctypes.c_int64)()
    n = lib.tsa_kmer_anchors(
        ref.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        len(ref),
        qry.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        len(qry),
        k,
        max_out,
        ctypes.byref(pri),
        ctypes.byref(pqi),
    )
    if n < 0:
        return None
    try:
        ri = np.ctypeslib.as_array(pri, shape=(n,)).copy() if n else np.zeros(0, np.int64)
        qi = np.ctypeslib.as_array(pqi, shape=(n,)).copy() if n else np.zeros(0, np.int64)
    finally:
        if n:
            lib.tsa_free(pri)
            lib.tsa_free(pqi)
    return ri, qi


def chain_native(
    ref_pos: np.ndarray,
    qry_pos: np.ndarray,
    k: int,
    match_score: int,
    window: int,
    max_gap: int,
    drift_unit: int = 1,
) -> Optional[np.ndarray]:
    """Best-chain anchor indices via the native windowed DP, or None."""
    lib = _build_and_load()
    if lib is None:
        return None
    ri = np.ascontiguousarray(ref_pos, dtype=np.int64)
    qi = np.ascontiguousarray(qry_pos, dtype=np.int64)
    out = np.zeros(len(ri), dtype=np.int64)
    n = lib.tsa_chain(
        ri.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        qi.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(ri),
        k,
        match_score,
        window,
        max_gap,
        drift_unit,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out[:n]
