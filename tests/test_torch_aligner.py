"""The port's aligner: random configurations, the fixture pair, no JAX.

  * under ``random_config`` the port's record equals the JAX engine's;
  * the port reproduces the 60-bp pair of tests/fixtures/torch_port_pairs.json
    (recorded from the JAX package by scripts/make_torch_port_fixture.py);
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

from torch_util import one_torch_thread  # noqa: F401
from util import random_config, related_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_pairs.json")


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
    got = tsalign_tpu_torch.Aligner(costs=cfg, device="cpu").align(r, q)
    assert _record(got) == _record(want)
    if got.has_target():
        assert price_alignment(cfg, ref, qry, got.result.alignment) == got.stats()["cost"]


def test_fixture_pair_matches_jax():
    with open(FIXTURE) as f:
        pairs = json.load(f)["pairs"]
    p = next(p for p in pairs if len(p["reference"]) == 60)
    got = tsalign_tpu_torch.align(p["reference"], p["query"], device="cpu")
    assert got.stats()["cost"] == p["cost"]
    assert got.cigar() == p["cigar"]


def test_fixture_pairs_are_the_smokes_planted_pairs():
    sys.path.insert(0, ROOT)
    from chip_smoke import planted_pair

    with open(FIXTURE) as f:
        pairs = json.load(f)["pairs"]
    for p in pairs:
        rng = np.random.default_rng(p["seed"])
        r, q = planted_pair(rng, len(p["reference"]), p["ts_len"], p["snps"], True)
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
