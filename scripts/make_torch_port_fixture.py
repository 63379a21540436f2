#!/usr/bin/env python3
"""Write tests/fixtures/torch_port_pairs.json: pairs aligned by the JAX package.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_fixture.py

Three seeded planted-template-switch pairs (one of 60 bp, two of 150-200 bp)
go through ``tsalign_tpu.align(..., engine="jax")`` under the default
configuration; their seeds, sequences, cost and CIGAR are written as the
fixture that ``chip_smoke.py`` (phase 4) and ``tests/test_torch_aligner.py``
hold the PyTorch/CUDA port against.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import tsalign_tpu  # noqa: E402
from chip_smoke import planted_pair  # noqa: E402

OUT = os.path.join(ROOT, "tests", "fixtures", "torch_port_pairs.json")
# (name, seed, reference length, planted reverse-complement length, SNPs)
PAIRS = (("planted_60", 60, 60, 12, 2), ("planted_150", 150, 150, 25, 3),
         ("planted_200", 200, 200, 30, 4))


def main():
    pairs = []
    for name, seed, n, ts_len, snps in PAIRS:
        r, q = planted_pair(np.random.default_rng(seed), n, ts_len, snps, True)
        t0 = time.monotonic()
        res = tsalign_tpu.align(r, q, engine="jax")
        print(f"{name}: cost {res.stats()['cost']} in {time.monotonic() - t0:.1f} s", flush=True)
        pairs.append(dict(name=name, seed=seed, ts_len=ts_len, snps=snps, reference=r,
                          query=q, cost=int(res.stats()["cost"]), cigar=res.cigar()))
    with open(OUT, "w") as f:
        json.dump({"config": "TemplateSwitchConfig.default(dna-n)",
                   "engine": "tsalign_tpu.align(engine='jax') on the CPU",
                   "pairs": pairs}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
