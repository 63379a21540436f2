"""The port's aligner: random configurations, the fixture pairs, no JAX.

  * under ``random_config``, flankless and flanked, and under a
    binding-window config with flanks 2 and 1, the port's record equals the
    JAX engine's;
  * the port reproduces the 60-bp pairs of tests/fixtures/torch_port_pairs.json
    and torch_port_flanked_pairs.json (recorded from the JAX package by
    scripts/make_torch_port_fixture.py);
  * in a subprocess where ``import jax`` fails, the port still aligns: the
    path the card's machine (which has no JAX) runs imports none of it.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import tsalign_tpu_torch
from tsalign_tpu.aligner import Aligner as JaxFacade
from tsalign_tpu.alphabet import get_alphabet
from tsalign_tpu.pricing import price_alignment
from tsalign_tpu_torch import alphabet as port_alphabet
from tsalign_tpu_torch.convert import config_from_reference

from torch_util import one_torch_thread  # noqa: F401
from util import binding_window_config, random_config, related_pair, related_pair_scaled

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_pairs.json")
FLANKED_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_flanked_pairs.json")


def _record(res):
    return "\n".join(
        line for line in res.to_toml().splitlines()
        if not line.startswith(("duration_seconds", "runtime"))
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_random_config_matches_jax_record(seed):
    rng = np.random.default_rng(1200 + seed)
    al = get_alphabet("dna")
    cfg = random_config(rng, al, flanks=False)
    ref, qry = related_pair(rng, al, max_len=14)
    r, q = al.decode(ref), al.decode(qry)
    want = JaxFacade(costs=cfg, engine="jax").align(r, q)
    got = tsalign_tpu_torch.Aligner(costs=config_from_reference(cfg), device="cpu").align(r, q)
    assert _record(got) == _record(want)
    if got.has_target():
        assert got.cigar() == want.cigar()
        assert price_alignment(cfg, ref, qry, want.result.alignment) == got.stats()["cost"]


@pytest.mark.parametrize("seed", range(5))
def test_random_flanked_config_matches_jax_record(seed):
    rng = np.random.default_rng(1300 + seed)
    al = get_alphabet("dna")
    cfg = random_config(rng, al, flanks=True)
    if cfg.left_flank_length + cfg.right_flank_length == 0:
        cfg.left_flank_length, cfg.right_flank_length = 2, 1
    ref, qry = related_pair(rng, al, max_len=14)
    r, q = al.decode(ref), al.decode(qry)
    want = JaxFacade(costs=cfg, engine="jax").align(r, q)
    got = tsalign_tpu_torch.Aligner(costs=config_from_reference(cfg), device="cpu").align(r, q)
    assert got.stats()["cost"] == want.stats()["cost"]
    assert got.cigar() == want.cigar()
    assert _record(got) == _record(want)


def test_binding_window_flanked_config_matches_jax_record():
    rng = np.random.default_rng(2040)
    al = get_alphabet("dna")
    cfg = binding_window_config(rng, al, 2, 1)
    ref, qry = related_pair_scaled(rng, al, 40, ts_len=8)
    r, q = al.decode(ref), al.decode(qry)
    want = JaxFacade(costs=cfg, engine="jax").align(r, q)
    got = tsalign_tpu_torch.Aligner(costs=config_from_reference(cfg), device="cpu").align(r, q)
    assert _record(got) == _record(want)
    assert got.has_target() and got.cigar() == want.cigar()


def test_fixture_pair_matches_jax():
    with open(FIXTURE) as f:
        pairs = json.load(f)["pairs"]
    p = next(p for p in pairs if len(p["reference"]) == 60)
    got = tsalign_tpu_torch.align(p["reference"], p["query"], device="cpu")
    assert got.stats()["cost"] == p["cost"]
    assert got.cigar() == p["cigar"]


def test_flanked_fixture_pair_matches_jax():
    sys.path.insert(0, ROOT)
    from chip_smoke import flanked_default

    with open(FLANKED_FIXTURE) as f:
        pairs = json.load(f)["pairs"]
    p = next(p for p in pairs if len(p["reference"]) == 60)
    cfg = flanked_default(port_alphabet.get_alphabet("dna-n"))
    got = tsalign_tpu_torch.Aligner(costs=cfg, device="cpu").align(p["reference"], p["query"])
    assert got.stats()["cost"] == p["cost"]
    assert got.cigar() == p["cigar"]


@pytest.mark.parametrize("flanked", [False, True])
def test_fixture_pairs_are_the_smokes_planted_pairs(flanked):
    sys.path.insert(0, ROOT)
    from chip_smoke import FLANKED_FIXTURE_PAIRS, planted_pair

    with open(FLANKED_FIXTURE if flanked else FIXTURE) as f:
        pairs = json.load(f)["pairs"]
    assert len(pairs) == 3
    if flanked:
        assert [(p["name"], p["seed"], len(p["reference"]), p["ts_len"], p["snps"])
                for p in pairs] == [tuple(spec) for spec in FLANKED_FIXTURE_PAIRS]
        assert all(60 <= len(p["reference"]) <= 120 for p in pairs)
    for p in pairs:
        rng = np.random.default_rng(p["seed"])
        r, q = planted_pair(rng, len(p["reference"]), p["ts_len"], p["snps"], True,
                            flank_snps=flanked)
        assert (r, q) == (p["reference"], p["query"]), p["name"]


def test_chip_smoke_without_a_card_fails_and_imports_no_jax():
    code = (
        "import runpy, sys; sys.modules['jax'] = None\n"
        "import torch; torch.cuda.is_available = lambda: False\n"
        "runpy.run_path('chip_smoke.py', run_name='__main__')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert '"ok"' not in out.stdout


def test_port_runs_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import tsalign_tpu_torch\n"
        "res = tsalign_tpu_torch.align('ACGTTGCAAGCTTGACCATGGCA', "
        "'ACGTTGCATTGCAAGTTGACCATGGCA', device='cpu')\n"
        "assert res.has_target()\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m, v in sys.modules.items()"
        " if v is not None)\n"
        "print(res.stats()['cost'])\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert float(out.stdout.strip().splitlines()[-1]) >= 0


def _variant_pair(seed):
    rng = np.random.default_rng(1400 + seed)
    al = get_alphabet("dna")
    cfg = random_config(rng, al, flanks=False)
    ref, qry = related_pair(rng, al, max_len=14)
    return cfg, al.decode(ref), al.decode(qry)


def _both(cfg, r, q, settings=None, **call):
    """The JAX facade's record and the port's, on the same settings and call."""
    from tsalign_tpu_torch.convert import range_from_reference

    settings = settings or {}
    want = JaxFacade(costs=cfg, engine="jax", **settings).align(r, q, **call)
    if "range_" in call:
        call = dict(call, range_=range_from_reference(call["range_"]))
    got = tsalign_tpu_torch.Aligner(costs=config_from_reference(cfg), device="cpu",
                                    **settings).align(r, q, **call)
    return got, want


@pytest.mark.parametrize("seed", [0, 1])
def test_prune_range_sub_range_matches_jax_record(seed):
    from tsalign_tpu.geometry import AlignmentRange

    cfg, r, q = _variant_pair(seed)
    rng = AlignmentRange(2, 1, len(r) - 1, len(q) - 2)
    got, want = _both(cfg, r, q, range_=rng, prune_range=True)
    assert _record(got) == _record(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_only_equal_descendant_strategy_matches_jax_record(seed):
    cfg, r, q = _variant_pair(seed)
    got, want = _both(cfg, r, q, {"template_switch_descendant_strategy": "only-equal"})
    assert _record(got) == _record(want)


@pytest.mark.parametrize("primaries", [(0,), (1,)])
def test_allowed_primaries_match_jax_engine(primaries):
    """One primary sequence for every TSM: cost, rounds, every kept field and
    the traced alignment, engine against engine."""
    from tsalign_tpu.jax_engine import JaxAligner
    from tsalign_tpu_torch.engine import TorchAligner
    from tsalign_tpu_torch.ops.common import from_device_costs

    cfg, r, q = _variant_pair(3)
    al = get_alphabet("dna")
    ref, qry = al.encode(r), al.encode(q)
    want_eng = JaxAligner(cfg, ref, qry, chunk=8, allowed_primaries=primaries)
    got_eng = TorchAligner(config_from_reference(cfg), ref, qry, device="cpu", chunk=8,
                           allowed_primaries=primaries)
    want, got = want_eng.align(), got_eng.align()
    assert (got.cost, got.rounds) == (want.cost, want.rounds)
    for v, M in zip(got.primary_fields, want.primary_fields):
        np.testing.assert_array_equal(from_device_costs(v._dev.numpy()), M)
    for v, R in zip(got.reentry_fields, want.reentry_fields):
        np.testing.assert_array_equal(from_device_costs(v._dev.numpy()), R)
    (cw, aw), (cg, ag) = want_eng.align_with_traceback(), got_eng.align_with_traceback()
    assert cg == cw and str(ag) == str(aw)


@pytest.mark.parametrize("seed", [0, 1])
def test_without_secondary_deletions_matches_jax_engine(seed):
    """allow_secondary_deletions=False: cost, rounds, fields and the traced
    alignment equal the JAX engine's."""
    from tsalign_tpu.jax_engine import JaxAligner
    from tsalign_tpu_torch.engine import TorchAligner
    from tsalign_tpu_torch.ops.common import from_device_costs

    cfg, r, q = _variant_pair(10 + seed)
    al = get_alphabet("dna")
    ref, qry = al.encode(r), al.encode(q)
    want_eng = JaxAligner(cfg, ref, qry, chunk=8, allow_secondary_deletions=False)
    got_eng = TorchAligner(config_from_reference(cfg), ref, qry, device="cpu", chunk=8,
                           allow_secondary_deletions=False)
    assert got_eng.allow_sdel is False
    want, got = want_eng.align(), got_eng.align()
    assert (got.cost, got.rounds) == (want.cost, want.rounds)
    for v, M in zip(got.primary_fields, want.primary_fields):
        np.testing.assert_array_equal(from_device_costs(v._dev.numpy()), M)
    for v, R in zip(got.reentry_fields, want.reentry_fields):
        np.testing.assert_array_equal(from_device_costs(v._dev.numpy()), R)
    (cw, aw), (cg, ag) = want_eng.align_with_traceback(), got_eng.align_with_traceback()
    assert cg == cw and str(ag) == str(aw)
    if cg < 2**40:
        assert price_alignment(cfg, ref, qry, aw) == cg


@pytest.mark.parametrize("below", [True, False])
def test_cost_limit_matches_jax_record(below):
    cfg, r, q = _variant_pair(4)
    cost = JaxFacade(costs=cfg, engine="jax").align(r, q).stats()["cost"]
    limit = cost - 1 if below else cost + 1
    got, want = _both(cfg, r, q, cost_limit=limit)
    assert _record(got) == _record(want)
    assert got.has_target() != below


@pytest.mark.parametrize("below", [True, False])
def test_memory_limit_matches_jax_record(below):
    cfg, r, q = _variant_pair(5)
    est = JaxFacade(costs=cfg, engine="jax")._estimate_memory(len(r), len(q))
    got, want = _both(cfg, r, q, memory_limit=est - 1 if below else est)
    assert _record(got) == _record(want)
    assert ("ExceededMemoryLimit" in got.to_toml()) == below
