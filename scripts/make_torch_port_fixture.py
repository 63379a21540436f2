#!/usr/bin/env python3
"""Write the port's fixtures: pairs aligned by the JAX package.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_fixture.py [default] [flanked] [batch]

``default`` writes tests/fixtures/torch_port_pairs.json: three seeded
planted-template-switch pairs (one of 60 bp, two of 150-200 bp) through
``tsalign_tpu.align(..., engine="jax")`` under the default configuration.
``flanked`` writes tests/fixtures/torch_port_flanked_pairs.json: three pairs
of 60-120 bp, each with a substitution on either side of the planted stretch,
through the JAX facade under the flanked default (the default configuration
with two flank layers on either side and flank tables of match 0,
substitution 1, gap open 2, gap extend 1).  ``batch`` writes
tests/fixtures/torch_port_batch_pairs.json: eight seeded planted pairs of
60-128 bp (two length buckets) through the JAX package's batched engine,
``tsalign_tpu.parallel.batch_ts.align_pairs``, under the default
configuration.  ``chain`` writes tests/fixtures/torch_port_chain_pairs.json:
the chained alignments (``tsalign_tpu.chain.chain_align(..., engine="jax")``)
of the 1.5 kb and 3 kb constructions of scripts/validate_chain_scale.py
(``chip_smoke.chain_construction``) under its narrow configuration
(tests/fixtures/torch_port_chain_cfg.tsa), and of a 160 bp pair under a
seeded random configuration, which the fixture carries as text.  With no
argument all four are written.  Seeds, sequences, cost and CIGAR (and for
the chained ones segments, anchors and rejoined cuts) go into the fixture
that ``chip_smoke.py`` (phases 4, 7 and 8) and the port's tests hold the
PyTorch/CUDA port against.
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
from chip_smoke import FLANKED_FIXTURE_PAIRS, planted_pair  # noqa: E402
from tsalign_tpu.aligner import Aligner  # noqa: E402
from tsalign_tpu.alphabet import get_alphabet  # noqa: E402
from tsalign_tpu.config import TemplateSwitchConfig  # noqa: E402
from tsalign_tpu.costs import GapAffineCostTable  # noqa: E402

OUT = os.path.join(ROOT, "tests", "fixtures", "torch_port_pairs.json")
FLANKED_OUT = os.path.join(ROOT, "tests", "fixtures", "torch_port_flanked_pairs.json")
BATCH_OUT = os.path.join(ROOT, "tests", "fixtures", "torch_port_batch_pairs.json")
# (name, length, seed, target segment) of the chained pairs under the narrow
# configuration
CHAIN_PAIRS = (("chain_1500", 1500, 3000, 512), ("chain_3000", 3000, 3000, 512))
# (name, seed, reference length, planted reverse-complement length, SNPs)
PAIRS = (("planted_60", 60, 60, 12, 2), ("planted_150", 150, 150, 25, 3),
         ("planted_200", 200, 200, 30, 4))


def flanked_default():
    """The JAX package's config equal to ``chip_smoke.flanked_default``."""
    al = get_alphabet("dna-n")
    cfg = TemplateSwitchConfig.default(al)
    cfg.left_flank_length = cfg.right_flank_length = 2
    cfg.left_flank_edit_costs = GapAffineCostTable.base_agnostic(
        "Left Flank Edit Costs", al, 0, 1, 2, 1)
    cfg.right_flank_edit_costs = GapAffineCostTable.base_agnostic(
        "Right Flank Edit Costs", al, 0, 1, 2, 1)
    return cfg


def write_flanked():
    aligner = Aligner(costs=flanked_default(), engine="jax")
    pairs = []
    for name, seed, n, ts_len, snps in FLANKED_FIXTURE_PAIRS:
        r, q = planted_pair(np.random.default_rng(seed), n, ts_len, snps, True, flank_snps=True)
        t0 = time.monotonic()
        res = aligner.align(r, q)
        print(f"{name}: cost {res.stats()['cost']} {res.cigar()} in "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        pairs.append(dict(name=name, seed=seed, ts_len=ts_len, snps=snps, reference=r,
                          query=q, cost=int(res.stats()["cost"]), cigar=res.cigar()))
    with open(FLANKED_OUT, "w") as f:
        json.dump({"config": "TemplateSwitchConfig.default(dna-n) with left/right flank "
                             "length 2 and flank tables base_agnostic(0, 1, 2, 1)",
                   "engine": "tsalign_tpu.Aligner(engine='jax') on the CPU",
                   "pairs": pairs}, f, indent=1)
        f.write("\n")


def write_default():
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


def write_batch():
    from chip_smoke import BATCH_FIXTURE_PAIRS
    from tsalign_tpu.parallel.batch_ts import align_pairs

    pairs, specs = [], []
    for name, seed, n, ts_len, snps in BATCH_FIXTURE_PAIRS:
        pairs.append(planted_pair(np.random.default_rng(seed), n, ts_len, snps, True))
        specs.append(dict(name=name, seed=seed, ts_len=ts_len, snps=snps))
    t0 = time.monotonic()
    records = align_pairs(TemplateSwitchConfig.default(get_alphabet("dna-n")), pairs,
                          names=[(s["name"], s["name"]) for s in specs])
    print(f"batch of {len(pairs)}: {time.monotonic() - t0:.1f} s", flush=True)
    out = []
    for spec, (r, q), rec in zip(specs, pairs, records):
        print(f"{spec['name']}: cost {rec.result.cost} {rec.cigar()}", flush=True)
        out.append(dict(spec, reference=r, query=q, cost=int(rec.result.cost),
                        cigar=rec.cigar()))
    with open(BATCH_OUT, "w") as f:
        json.dump({"config": "TemplateSwitchConfig.default(dna-n)",
                   "engine": "tsalign_tpu.parallel.batch_ts.align_pairs on the CPU "
                             "(its host rounds loop)",
                   "pairs": out}, f, indent=1)
        f.write("\n")


def random_chain_pair():
    """The 160 bp pair and random configuration of
    tests/test_chain.py::test_chain_align_jax_engine_matches_full."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from util import random_config

    rng = np.random.default_rng(11)
    al = get_alphabet("dna")
    cfg = random_config(rng, al, flanks=False)
    n = 160
    ref = rng.integers(0, 4, size=n).astype(np.int8)
    qry = ref.copy()
    comp = al.complement_array()
    a, b = 60, 60 + max(3, cfg.template_switch_min_length + 1)
    qry[a:b] = [comp[c] for c in qry[a:b]][::-1]
    qry[20] = (qry[20] + 1) % 4
    return cfg, ref, qry


def write_chain():
    from chip_smoke import CHAIN_CFG, CHAIN_FIXTURE, chain_construction
    from tsalign_tpu.chain import chain_align

    al = get_alphabet("dna-n")
    with open(CHAIN_CFG) as f:
        narrow = TemplateSwitchConfig.parse_plain(f.read(), al)
    cases = []
    for name, n, seed, target in CHAIN_PAIRS:
        ref, qry, expected, _ = chain_construction(n, seed)
        cases.append((dict(name=name, seed=seed, config="narrow", alphabet="dna-n",
                           target_segment=target, expected_cost=expected), narrow, ref, qry))
    cfg, ref, qry = random_chain_pair()
    cases.append((dict(name="random_160", seed=11, config=cfg.display(), alphabet="dna",
                       target_segment=48), cfg, ref, qry))
    out = []
    for spec, cfg, ref, qry in cases:
        t0 = time.monotonic()
        res = chain_align(cfg, ref, qry, target_segment=spec["target_segment"], engine="jax")
        print(f"{spec['name']}: cost {res.cost}, {res.segments} segments, {res.anchors} "
              f"anchors in {time.monotonic() - t0:.1f} s", flush=True)
        alph = get_alphabet(spec["alphabet"])
        out.append(dict(spec, reference=alph.decode(ref), query=alph.decode(qry),
                        cost=int(res.cost), cigar=res.alignment.cigar(),
                        segments=res.segments, anchors=res.anchors,
                        cuts_rejoined=res.cuts_rejoined,
                        ts_total_length=res.ts_total_length))
    with open(CHAIN_FIXTURE, "w") as f:
        json.dump({"config": "narrow: tests/fixtures/torch_port_chain_cfg.tsa; otherwise the "
                             "configuration's text",
                   "engine": "tsalign_tpu.chain.chain_align(engine='jax') on the CPU",
                   "pairs": out}, f, indent=1)
        f.write("\n")


def main():
    which = sys.argv[1:] or ["default", "flanked", "batch", "chain"]
    if "default" in which:
        write_default()
    if "flanked" in which:
        write_flanked()
    if "batch" in which:
        write_batch()
    if "chain" in which:
        write_chain()


if __name__ == "__main__":
    main()
