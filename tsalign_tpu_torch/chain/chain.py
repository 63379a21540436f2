"""Co-linear anchor chaining.

Counterpart of the reference's anchor-graph chainer
(lib_ts_chainalign/src/chain_align/chainer.rs) re-shaped for dense
vectorized execution: anchors sorted by reference position, a windowed
chain DP (each anchor scans a bounded predecessor window, fully
vectorizable), gap costs lower-bounded by diagonal drift + gap length.
The chain picks the cut structure only — exact costs come from the dense
per-segment alignment afterwards, which plays the role of the reference's
iterative exact chain evaluation (chain_align.rs:157-282) without the
re-chaining loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from .anchors import Anchors


@dataclass
class Chain:
    """Selected increasing anchor chain (positions of k-mer starts)."""

    k: int
    ref_pos: np.ndarray
    qry_pos: np.ndarray

    def __len__(self):
        return len(self.ref_pos)


def compute_chain(
    anchors: Anchors,
    match_score: int = 8,
    window: int = 64,
    max_gap: int = 5000,
    drift_unit: int = 1,
) -> Chain:
    """Windowed chain DP (minimap-style): score[a] = k*match - gaps.

    `match_score` and `drift_unit` come from the preprocessing plan
    (chain/plan.py): the cheapest mismatch cost and the cheapest gap-extend
    cost of the primary table — config-derived slope counterparts of the
    reference's GapAffineLowerBounds gap pricing."""
    n = len(anchors)
    if n == 0:
        return Chain(anchors.k, np.zeros(0, np.int64), np.zeros(0, np.int64))
    i = anchors.ref_pos
    j = anchors.qry_pos
    k = anchors.k
    from .native import chain_native

    idx_native = chain_native(i, j, k, match_score, window, max_gap, drift_unit)
    if idx_native is not None:
        return Chain(k, i[idx_native], j[idx_native])
    score = np.full(n, k * match_score, dtype=np.int64)
    parent = np.full(n, -1, dtype=np.int64)
    for a in range(n):
        lo = max(0, a - window)
        if lo == a:
            continue
        pi, pj = i[lo:a], j[lo:a]
        di = i[a] - pi
        dj = j[a] - pj
        ok = (di > 0) & (dj > 0) & (di < max_gap) & (dj < max_gap)
        overlap = np.maximum(0, k - np.minimum(di, dj))
        gain = k - overlap
        gap_cost = np.abs(di - dj) * drift_unit + np.minimum(di, dj) // 8
        cand = np.where(ok, score[lo:a] + gain * match_score - gap_cost, -(2**62))
        b = int(np.argmax(cand))
        if cand[b] > score[a]:
            score[a] = int(cand[b])
            parent[a] = lo + b
    best = int(np.argmax(score))
    path = []
    a = best
    while a >= 0:
        path.append(a)
        a = int(parent[a])
    path.reverse()
    idx = np.asarray(path, dtype=np.int64)
    return Chain(k, i[idx], j[idx])


def exact_match_runs(chain: Chain) -> List[Tuple[int, int, int]]:
    """Maximal diagonal runs of consecutive chain anchors:
    [(ref_start, qry_start, length_in_chars)] where the whole run is an
    exact match of length >= k."""
    out: List[Tuple[int, int, int]] = []
    n = len(chain)
    if n == 0:
        return out
    i, j, k = chain.ref_pos, chain.qry_pos, chain.k
    run_start = 0
    for a in range(1, n + 1):
        end_of_run = (
            a == n
            or i[a] - i[a - 1] != j[a] - j[a - 1]
            or i[a] - i[a - 1] > k
        )
        if end_of_run:
            r0, q0 = int(i[run_start]), int(j[run_start])
            length = int(i[a - 1]) + k - r0
            out.append((r0, q0, length))
            run_start = a
    return out
