"""The port's aligner end to end against the JAX package (default config
and flanked configs).

``tsalign_tpu_torch.align(..., device="cpu")`` and
``tsalign_tpu.align(..., engine="jax")`` (the JAX engine's host rounds loop on
the CPU) must give the same cost, CIGAR and TOML record (all but its wall
times), including under ``max_template_switches`` 0 and 1, and the port's
alignment must reprice to its cost.  The same holds under the flanked default
(two flank layers on either side, cheaper flank tables; the config that
``chip_smoke.py`` runs on the card) with ``max_template_switches`` 0, 1 and 2,
which gates the left-flank climb per round, and under a binding-window config
with flanks 2 and 1, where the engines' rounds and fields are compared too.
Pairs of one test share a length, so the JAX package compiles its programs
once.
"""

import os
import sys

import numpy as np
import pytest

import tsalign_tpu
import tsalign_tpu_torch
from tsalign_tpu.aligner import Aligner as JaxFacade
from tsalign_tpu.alphabet import get_alphabet
from tsalign_tpu.config import TemplateSwitchConfig
from tsalign_tpu.costs import GapAffineCostTable
from tsalign_tpu.jax_engine import JaxAligner
from tsalign_tpu.pricing import price_alignment
from tsalign_tpu_torch import alphabet as port_alphabet
from tsalign_tpu_torch import pricing as port_pricing
from tsalign_tpu_torch.convert import config_from_reference
from tsalign_tpu_torch.engine import TorchAligner

from torch_util import one_torch_thread  # noqa: F401
from util import binding_window_config, related_pair_scaled

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import flanked_default, planted_pair, reprice  # noqa: E402

N = 44


def _pair(seed):
    rng = np.random.default_rng(seed)
    al = get_alphabet("dna")
    ref, qry = related_pair_scaled(rng, al, N, 10)
    return al.decode(ref), al.decode(qry)


def _record(res):
    """The TOML record without its wall-time lines."""
    return "\n".join(
        line for line in res.to_toml().splitlines()
        if not line.startswith(("duration_seconds", "runtime"))
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_align_matches_jax_record(seed):
    r, q = _pair(seed)
    want = tsalign_tpu.align(r, q, engine="jax")
    got = tsalign_tpu_torch.align(r, q, device="cpu")
    assert got.stats()["cost"] == want.stats()["cost"]
    assert got.cigar() == want.cigar()
    assert _record(got) == _record(want)
    al = get_alphabet("dna-n")
    cfg = TemplateSwitchConfig.default(al)
    assert price_alignment(cfg, al.encode(r), al.encode(q), want.result.alignment) == (
        got.stats()["cost"])
    port_al = port_alphabet.get_alphabet("dna-n")
    assert port_pricing.price_alignment(
        config_from_reference(cfg), port_al.encode(r), port_al.encode(q),
        got.result.alignment) == got.stats()["cost"]


@pytest.mark.parametrize("max_ts", [0, 1])
def test_max_template_switches_matches_jax(max_ts):
    r, q = _pair(0)
    want = tsalign_tpu.align(r, q, engine="jax", max_template_switches=max_ts)
    got = tsalign_tpu_torch.align(r, q, device="cpu", max_template_switches=max_ts)
    assert _record(got) == _record(want)
    assert got.stats()["template_switch_amount"] <= max_ts


def test_no_ts_matches_jax():
    r, q = _pair(0)
    want = tsalign_tpu.align(r, q, engine="jax", no_ts=True)
    got = tsalign_tpu_torch.align(r, q, device="cpu", no_ts=True)
    assert _record(got) == _record(want)
    assert got.stats()["template_switch_amount"] == 0


def test_aligner_needs_a_device():
    with pytest.raises(ValueError):
        tsalign_tpu_torch.Aligner()
    with pytest.raises(TypeError):
        tsalign_tpu_torch.align("ACGT", "ACGT")


def test_plain_text_view_is_not_ported():
    res = tsalign_tpu_torch.align("ACGTACGT", "ACGTACGT", device="cpu")
    with pytest.raises(NotImplementedError, match="show/"):
        res.viz_template_switches()


def _reference_flanked_default():
    """The JAX package's config equal to ``chip_smoke.flanked_default``."""
    al = get_alphabet("dna-n")
    cfg = TemplateSwitchConfig.default(al)
    cfg.left_flank_length = cfg.right_flank_length = 2
    for side in ("Left", "Right"):
        table = GapAffineCostTable.base_agnostic(f"{side} Flank Edit Costs", al, 0, 1, 2, 1)
        setattr(cfg, f"{side.lower()}_flank_edit_costs", table)
    return cfg


def test_flanked_default_is_the_converted_reference_config():
    got = flanked_default(port_alphabet.get_alphabet("dna-n"))
    assert got.display() == _reference_flanked_default().display()
    assert got.display() == config_from_reference(_reference_flanked_default()).display()
    assert (got.left_flank_length, got.right_flank_length) == (2, 2)
    assert got.left_flank_edit_costs != got.primary_edit_costs


def _climb_gated_pair():
    """A planted pair whose second-to-last base is substituted too: that
    substitution costs 1 where the last sweep may climb the left flank and 2
    where it may not, so the cost shows the per-round climb gating."""
    r, q = planted_pair(np.random.default_rng(77), 36, 9, 1, True, flank_snps=True)
    return r, q[:-2] + ("A" if q[-2] != "A" else "C") + q[-1]


@pytest.mark.parametrize("max_ts", [None, 0, 1, 2])
def test_flanked_default_matches_jax_record(max_ts):
    r, q = _climb_gated_pair()
    cfg = _reference_flanked_default()
    port_cfg = flanked_default(port_alphabet.get_alphabet("dna-n"))
    want = JaxFacade(costs=cfg, engine="jax").align(r, q, max_template_switches=max_ts)
    got = tsalign_tpu_torch.Aligner(costs=port_cfg, device="cpu").align(
        r, q, max_template_switches=max_ts)
    assert got.stats()["cost"] == want.stats()["cost"]
    assert got.cigar() == want.cigar()
    assert _record(got) == _record(want)
    if max_ts is None:  # `reprice` knows no template-switch limit
        al = port_cfg.alphabet
        priced, flank_ops = reprice(port_cfg, al.encode(r), al.encode(q), got.result.alignment)
        assert priced == got.stats()["cost"]
        assert flank_ops == 4 * got.stats()["template_switch_amount"] + 2
    if max_ts is not None:
        assert got.stats()["template_switch_amount"] <= max_ts


def test_flanked_climb_is_gated_per_round():
    """No left-flank climb in the last allowed round: the end substitution
    costs one more under max_template_switches 0 and 1 than under 2."""
    r, q = _climb_gated_pair()
    port_cfg = flanked_default(port_alphabet.get_alphabet("dna-n"))
    aligner = tsalign_tpu_torch.Aligner(costs=port_cfg, device="cpu")
    cost = {t: aligner.align(r, q, max_template_switches=t).stats()["cost"] for t in (1, 2)}
    assert cost[1] == cost[2] + 1


@pytest.mark.parametrize("seed", [2040, 2041])
def test_binding_window_flanked_engine_matches_jax(seed):
    """Engine against engine under flanks 2 and 1 and narrow windows: cost,
    rounds, and cells and entry layer of every kept field."""
    rng = np.random.default_rng(seed)
    al = get_alphabet("dna")
    cfg = binding_window_config(rng, al, 2, 1)
    ref, qry = related_pair_scaled(rng, al, 40, ts_len=8)
    want = JaxAligner(cfg, ref, qry, chunk=32, keep_fields=True).align()
    eng = TorchAligner(config_from_reference(cfg), ref, qry, device="cpu", chunk=32)
    got = eng.align()
    assert (got.cost, got.rounds) == (want.cost, want.rounds)
    assert len(got.primary_fields) == len(want.primary_fields)
    i = len(ref) // 2
    for M_got, M_want in zip(got.primary_fields, want.primary_fields):
        assert M_got.shape == M_want.shape == (4, 3, len(ref) + 1, len(qry) + 1)
        np.testing.assert_array_equal(M_got[:, :, i, i], M_want[:, :, i, i])
        np.testing.assert_array_equal(M_got.entry_cells(), M_want[-1].min(axis=0))
    assert eng.cells_swept >= 4 * 3 * (len(ref) + 1) * (len(qry) + 1) * len(got.primary_fields)
