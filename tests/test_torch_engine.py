"""The port's aligner end to end against the JAX package (default config).

``tsalign_tpu_torch.align(..., device="cpu")`` and
``tsalign_tpu.align(..., engine="jax")`` (the JAX engine's host rounds loop on
the CPU) must give the same cost, CIGAR and TOML record (all but its wall
times), including under ``max_template_switches`` 0 and 1, and the port's
alignment must reprice to its cost.  All pairs share one length, so the JAX
package compiles its programs once.
"""

import numpy as np
import pytest

import tsalign_tpu
import tsalign_tpu_torch
from tsalign_tpu.alphabet import get_alphabet
from tsalign_tpu.config import TemplateSwitchConfig
from tsalign_tpu.pricing import price_alignment

from torch_util import one_torch_thread  # noqa: F401
from util import related_pair_scaled

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
    assert price_alignment(cfg, al.encode(r), al.encode(q), got.result.alignment) == (
        got.stats()["cost"])


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
