"""Poison-padded (bucketed) problems in the port, against the JAX package.

A bucketed problem pads a pair with the poison char (index == alphabet
size) to a shared shape; every structural feasibility still derives from the
real lengths (tests/test_padded_soundness.py).  Here, with tolerance 0:

  * ``assembly_torch`` on a bucketed kind against ``jax_modules._assembly``
    with ``st.padded``, on the same B and A_chunk, for several real anti
    lengths (the positive-ldiff band with its per-row window widths);
  * the port's ``TorchAligner`` on padded pairs against ``JaxAligner``: cost,
    rounds, every primary and reentry field;
  * the cases of tests/test_padded_soundness.py on the port: the
    padded_rewind fixture's cost against the port's oracle, and tracebacks
    that reprice.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsalign_tpu.alphabet import get_alphabet
from tsalign_tpu.config import TemplateSwitchConfig
from tsalign_tpu.geometry import AlignmentRange
from tsalign_tpu.jax_engine import JaxAligner
from tsalign_tpu.ops.jax_modules import JaxKindModule, _assembly
from tsalign_tpu.ops.tsm_modules import make_kind_spec
from tsalign_tpu_torch import geometry as port_geometry
from tsalign_tpu_torch import oracle as port_oracle
from tsalign_tpu_torch import pricing as port_pricing
from tsalign_tpu_torch.convert import config_from_reference
from tsalign_tpu_torch.engine import TorchAligner
from tsalign_tpu_torch.ops import tsm_modules as port_tsm
from tsalign_tpu_torch.ops.common import DEV_INF, from_device_costs
from tsalign_tpu_torch.ops.modules import KindModule, assembly_torch

from torch_util import one_torch_thread  # noqa: F401
from util import random_config, related_pair

HERE = os.path.dirname(os.path.abspath(__file__))


def _pad(seq, n, P):
    out = np.full(n, P, dtype=np.asarray(seq).dtype)
    out[: len(seq)] = seq
    return out


def _positive_config(seed):
    """A random config whose length-difference function has a finite
    positive segment (the band the real anti length cuts)."""
    al = get_alphabet("dna")
    rng = np.random.default_rng(seed)
    while True:
        cfg = random_config(rng, al, flanks=False)
        w = cfg.length_difference_costs.finite_window()
        if w is not None and w[1] >= 2:
            return cfg


@pytest.mark.parametrize("n_q_real", [20, 17, 11, 6, 2])
def test_padded_assembly_matches_jax(n_q_real):
    cfg = _positive_config(40)
    port_cfg = config_from_reference(cfg)
    al = get_alphabet("dna")
    rng = np.random.default_rng(n_q_real)
    n_r, n_q = 14, 20
    ref = rng.integers(0, 4, size=n_r).astype(np.int8)
    qry = _pad(rng.integers(0, 4, size=n_q_real).astype(np.int8), n_q, al.size)
    checked = 0
    for sk in (0, 1):
        for dk in (0, 1):
            kw = dict(sdel_budget=16, n_ref_real=n_r, n_qry_real=n_q_real)
            spec = make_kind_spec(cfg, n_r, n_q, 0, sk, dk, **kw)
            if spec is None:
                continue
            port_spec = port_tsm.make_kind_spec(port_cfg, n_r, n_q, 0, sk, dk, **kw)
            jkm = JaxKindModule(spec, cfg, ref, qry, 0, n_q, chunk=5)
            km = KindModule(port_spec, port_cfg, ref, qry, 0, n_q, chunk=5)
            if not jkm.active:
                continue
            st = jkm._static
            assert st.padded and km.padded
            assert km.ah_real == int(jkm._fixed["ah_real"]) == min(n_q, n_q_real)
            C = km.chunk
            A_chunk = rng.integers(0, 30, size=(spec.n_p + 1, C)).astype(np.int32)
            A_chunk[rng.random(A_chunk.shape) < 0.3] = DEV_INF
            shape = (st.L + 1, spec.n_p + 1) + (() if spec.same_seq else (C,))
            B = rng.integers(0, 40, size=shape).astype(np.int32)
            B[rng.random(B.shape) < 0.3] = DEV_INF
            want = np.asarray(_assembly(jnp.asarray(B), jnp.asarray(A_chunk), jkm._fixed, st))
            got = assembly_torch(torch.from_numpy(B), torch.from_numpy(A_chunk), km,
                                 km.tables("cpu"))
            np.testing.assert_array_equal(got.numpy(), want)
            checked += any(p.positive for p in km.plans)
    assert checked


def _padded_pairs(seed, n_pairs, bucket):
    rng = np.random.default_rng(seed)
    al = get_alphabet("dna")
    cfg = random_config(rng, al, flanks=False)
    pairs = [related_pair(rng, al, max_len=12) for _ in range(n_pairs)]
    return cfg, al, [(_pad(r, bucket, al.size), _pad(q, bucket, al.size), len(r), len(q))
                     for r, q in pairs]


def _fields(res):
    """A port engine result's kept fields as host int64 arrays."""
    return ([from_device_costs(v._dev.cpu().numpy()) for v in res.primary_fields],
            [from_device_costs(v._dev.cpu().numpy()) for v in res.reentry_fields])


@pytest.mark.parametrize("seed", [60, 61, 62])
def test_padded_engine_matches_jax(seed):
    cfg, al, pairs = _padded_pairs(seed, 2, 16)
    port_cfg = config_from_reference(cfg)
    for rp, qp, lr, lq in pairs:
        rng = AlignmentRange(0, 0, lr, lq)
        want = JaxAligner(cfg, rp, qp, range_=rng, chunk=8).align()
        got = TorchAligner(port_cfg, rp, qp, device="cpu", chunk=8,
                           range_=port_geometry.AlignmentRange(0, 0, lr, lq)).align()
        assert (got.cost, got.rounds) == (want.cost, want.rounds)
        M, R = _fields(got)
        assert len(M) == len(want.primary_fields) and len(R) == len(want.reentry_fields)
        for a, b in zip(M, want.primary_fields):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(R, want.reentry_fields):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def rewind_case():
    al = get_alphabet("dna")
    cfg = TemplateSwitchConfig.parse_plain(
        open(os.path.join(HERE, "fixtures", "padded_rewind_cfg.tsa")).read(), al)
    pairs = json.load(open(os.path.join(HERE, "fixtures", "padded_rewind_pairs.json")))["pairs"]
    return al, cfg, [(al.encode(r), al.encode(q)) for r, q in pairs]


@pytest.mark.parametrize("i", [0, 1, 2])
def test_padded_rewind_pairs_match_the_oracle_and_reprice(rewind_case, i):
    al, cfg, enc = rewind_case
    port_cfg = config_from_reference(cfg)
    r, q = enc[i]
    want, _ = port_oracle.OracleAligner(port_cfg, r, q).align()
    rp, qp = _pad(r, 64, al.size), _pad(q, 64, al.size)
    eng = TorchAligner(port_cfg, rp, qp, device="cpu",
                       range_=port_geometry.AlignmentRange(0, 0, len(r), len(q)))
    cost, aln = eng.align_with_traceback()
    assert cost == want == [4, 10, 4][i]
    assert port_pricing.price_alignment(port_cfg, r, q, aln) == cost
