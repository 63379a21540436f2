"""Vectorized k-mer anchor extraction.

Counterpart of lib_ts_chainalign/src/anchors (2-bit k-mer packing,
sort-based matching, merge-join of duplicate clusters — anchors.rs:34-160,
kmer_matches.rs:32-76), redesigned as flat numpy array ops: pack all k-mers
with a rolling 2-bit encoding, sort both sides once, and intersect with a
merge join.  A native C++ kernel (csrc/) accelerates the packing + join for
very long sequences when built; the numpy path is the fallback and spec.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


def pack_kmers(seq: np.ndarray, k: int, salt: int = 0) -> np.ndarray:
    """2-bit pack every k-mer of `seq` (values 0..3; other values poison the
    window).  Returns (len(seq)-k+1,) uint64 codes; poisoned windows get a
    per-(salt, position) unique sentinel above 2^62 so they never match any
    window of either sequence."""
    n = len(seq)
    if k > 31:
        raise ValueError("k-mer length must be <= 31 for 2-bit packing")
    if n < k or k == 0:
        return np.zeros(0, dtype=np.uint64)
    s = np.asarray(seq, dtype=np.int64)
    bad = (s < 0) | (s > 3)
    vals = np.where(bad, 0, s).astype(np.uint64)
    # rolling pack via strided matmul-free approach: cumulative shifts
    m = n - k + 1
    codes = np.zeros(m, dtype=np.uint64)
    for off in range(k):
        codes = (codes << np.uint64(2)) | vals[off : off + m]
    # windows containing a poisoned char never match
    bad_win = np.convolve(bad.astype(np.int64), np.ones(k, dtype=np.int64), "valid") > 0
    sentinel = (
        (np.uint64(1) << np.uint64(63))
        | (np.uint64(salt & 1) << np.uint64(62))
        | np.arange(m, dtype=np.uint64)
    )
    codes = np.where(bad_win, sentinel, codes)
    return codes


def merge_join(codes1: np.ndarray, codes2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """All (i, j) with codes1[i] == codes2[j], via sort + searchsorted with
    cartesian expansion of duplicate clusters (kmer_matches.rs:32-76)."""
    if len(codes1) == 0 or len(codes2) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    o1 = np.argsort(codes1, kind="stable")
    o2 = np.argsort(codes2, kind="stable")
    c1 = codes1[o1]
    c2 = codes2[o2]
    lo = np.searchsorted(c2, c1, side="left")
    hi = np.searchsorted(c2, c1, side="right")
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    rep1 = np.repeat(np.arange(len(c1)), counts)
    starts = np.repeat(lo, counts)
    within = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    idx2 = starts + within
    return o1[rep1], o2[idx2]


@dataclass
class Anchors:
    """Primary (forward x forward) k-mer matches of a pair, sorted by
    (reference, query) start."""

    k: int
    ref_pos: np.ndarray
    qry_pos: np.ndarray
    native: bool = False  # built by the native kernel (csrc/anchors.cpp)

    @classmethod
    def build(
        cls, reference: np.ndarray, query: np.ndarray, k: int, use_native: bool = True
    ) -> "Anchors":
        native = None
        if use_native:
            from .native import kmer_anchors_native

            native = kmer_anchors_native(reference, query, k)
        if native is not None:
            i, j = native
        else:
            c1 = pack_kmers(reference, k, salt=0)
            c2 = pack_kmers(query, k, salt=1)
            i, j = merge_join(c1, c2)
        order = np.lexsort((j, i))
        return cls(k=k, ref_pos=i[order], qry_pos=j[order], native=native is not None)

    def __len__(self):
        return len(self.ref_pos)


def choose_k(n_total: int) -> int:
    """k = clamp(ceil(log2(len sum)) - 3, >= 2) (tsalign/src/util.rs:35-44)."""
    k = 2
    while (1 << k) < n_total:
        k += 1
    return max(k - 3, 2)
