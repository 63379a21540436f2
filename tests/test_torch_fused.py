"""The port's fused rounds loop (``parallel/fused_rounds.py``) against the JAX
package's fused loop and the port's own host loop, exactly (tolerance 0).

The narrow config and the three pairs of ``tests/test_fused_rounds.py`` (a
planted reverse-complement stretch, identical twins that stop at round 1,
two SNPs and another stretch), in one batch: costs, rounds, the kept field
counts and every kept round's primary field, entry layer and reentry field;
the tracebacks and the facade's TOML record (the record fields in which the
JAX package's own two loops differ are the only ones allowed to differ
between the port's).  Then the single-pair delegation: each of its four
conditions keeps the pair on the host loop, the default takes the fused
loop, the round cap falls back to the host loop, and any other exception in
the fused loop propagates.  The host reads at most two control tensors a
round, none of them field-sized.
"""

import os
import sys

import numpy as np
import pytest
import torch

from tsalign_tpu.aligner import Aligner as JaxFacade
from tsalign_tpu.alphabet import get_alphabet
from tsalign_tpu.config import TemplateSwitchConfig
from tsalign_tpu.geometry import AlignmentRange
from tsalign_tpu.jax_engine import JaxAligner
from tsalign_tpu.parallel.batch_ts import BatchedTSAligner as JaxBatch
from tsalign_tpu_torch import engine as port_engine
from tsalign_tpu_torch.aligner import Aligner as PortFacade
from tsalign_tpu_torch.convert import config_from_reference, range_from_reference
from tsalign_tpu_torch.engine import TorchAligner
from tsalign_tpu_torch.fields import entry_cells_of
from tsalign_tpu_torch.parallel import fused_rounds
from tsalign_tpu_torch.parallel.batch_ts import BatchedTSAligner

from torch_util import one_torch_thread  # noqa: F401
import test_fused_rounds

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import planted_pair  # noqa: E402

CPU = torch.device("cpu")


def _cfg():
    return test_fused_rounds._narrow_config()


def _jax_loop(monkeypatch, fused: bool):
    if fused:
        monkeypatch.setenv("TSALIGN_FUSED", "1")
        monkeypatch.delenv("TSALIGN_NO_FUSED", raising=False)
    else:
        monkeypatch.setenv("TSALIGN_NO_FUSED", "1")
        monkeypatch.delenv("TSALIGN_FUSED", raising=False)


def _port_batch(fused, keep):
    return BatchedTSAligner(config_from_reference(_cfg()), test_fused_rounds._pairs(),
                            chunk=16, keep_fields=keep, device=CPU, fused=fused)


def test_fused_loop_matches_jax_fused_and_port_host(monkeypatch):
    _jax_loop(monkeypatch, True)
    want = JaxBatch(_cfg(), test_fused_rounds._pairs(), chunk=16, keep_fields=True).align()
    fused_rounds.control_reads.clear()
    bt = _port_batch(True, True)
    got = bt.align()
    reads = list(fused_rounds.control_reads)
    host = _port_batch(False, True).align()
    views = _port_batch(True, "device").align()
    assert [r.rounds for r in got][1] == 1
    for g, w, h, v in zip(got, want, host, views):
        assert (g.cost, g.rounds) == (w.cost, w.rounds) == (h.cost, h.rounds)
        for other in (w, h, v):
            assert len(g.primary_fields) == len(other.primary_fields)
            assert len(g.reentry_fields) == len(other.reentry_fields)
        for M, Mw, Mh, Mv in zip(g.primary_fields, w.primary_fields, h.primary_fields,
                                 v.primary_fields):
            assert np.array_equal(M, Mw) and np.array_equal(M, Mh)
            assert np.array_equal(entry_cells_of(Mv), M[-1].min(axis=0))
            assert Mv[0, 0, 3, 5] == M[0, 0, 3, 5]
        for R, Rw, Rh, Rv in zip(g.reentry_fields, w.reentry_fields, h.reentry_fields,
                                 v.reentry_fields):
            assert np.array_equal(R, Rw) and np.array_equal(R, Rh)
            assert Rv[7, 9] == R[7, 9]
    # at most two control reads a round, each a flag or the chunk liveness
    per_round = {}
    for loop, k, n in reads:
        per_round[loop, k] = per_round.get((loop, k), 0) + 1
    assert reads and max(per_round.values()) <= 2
    chunks = sum(len(e_bases) for *_, e_bases in bt._kind_state)
    assert max(n for *_, n in reads) <= 1 + len(got) * chunks < (bt.nr + 1) * (bt.nq + 1)
    assert {e["route"] for e in bt.route_log} == {"fused"}


def test_fused_traceback_matches_jax_and_host(monkeypatch):
    _jax_loop(monkeypatch, True)
    want = JaxBatch(_cfg(), test_fused_rounds._pairs(), chunk=16).align_with_traceback()
    got = _port_batch(True, False).align_with_traceback()
    host = _port_batch(False, False).align_with_traceback()
    for (cg, ag), (cw, aw), (ch, ah) in zip(got, want, host):
        assert cg == cw == ch
        assert ag.entries == ah.entries
        assert repr(ag.entries) == repr(aw.entries)


def _record(res):
    return res.to_toml().splitlines()


def _differing(a, b):
    """The record keys whose lines differ."""
    return {x.split("=")[0].strip() for x, y in zip(a, b) if x != y}


def _planted_default():
    """A 40 x 36 planted pair under the default config, whose rounds end by
    the no-sweep stop: there the fused loop's cell count (opened_nodes)
    counts one sweep more than the host loop runs, in both packages."""
    al = get_alphabet("dna-n")
    r, q = planted_pair(np.random.default_rng(500), 40, 8, 2, True, q_len=36)
    return TemplateSwitchConfig.default(al), r, q


@pytest.mark.parametrize("case", ["narrow", "default"])
def test_fused_record_matches_jax(monkeypatch, case):
    """The facade's record through the delegation equals the JAX package's
    through its own; fused and host records differ in the same keys in both
    packages (the wall lines, and opened_nodes where the rounds end by the
    no-sweep stop)."""
    if case == "narrow":
        cfg = _cfg()
        r, q = (cfg.alphabet.decode(s) for s in test_fused_rounds._pairs()[0])
    else:
        cfg, r, q = _planted_default()
    jax = {}
    for fused in (True, False):
        _jax_loop(monkeypatch, fused)
        jax[fused] = _record(JaxFacade(costs=cfg, engine="jax", chunk=16).align(r, q))
    port = {fused: _record(PortFacade(costs=config_from_reference(cfg), chunk=16, device="cpu",
                                      fused=fused).align(r, q))
            for fused in (True, False)}
    allowed = _differing(jax[True], jax[False])
    assert _differing(port[True], port[False]) == allowed
    assert allowed - {"duration_seconds", "runtime"} == (
        set() if case == "narrow" else {"opened_nodes"})
    assert _differing(port[True], jax[True]) <= {"duration_seconds", "runtime"}
    assert len(port[True]) == len(jax[True])


def _engine(**kw):
    cfg = config_from_reference(_cfg())
    ref, qry = test_fused_rounds._pairs()[0]
    return TorchAligner(cfg, ref, qry, device=CPU, chunk=16, fused=True, keep_fields=False,
                        **kw)


def test_delegation_follows_its_conditions(monkeypatch):
    ref, qry = test_fused_rounds._pairs()[0]
    rng = AlignmentRange(4, 4, len(ref) - 3, len(qry) - 3)
    _jax_loop(monkeypatch, True)
    want = JaxAligner(_cfg(), ref, qry, chunk=16, keep_fields=False, range_=rng).align()
    got = _engine(range_=range_from_reference(rng))
    res = got.align()
    assert got.loop == "fused" and (res.cost, res.rounds) == (want.cost, want.rounds)
    assert {e["route"] for e in got.route_log} == {"fused"}
    default = _engine()
    cost = default.align().cost
    assert default.loop == "fused"
    assert TorchAligner(config_from_reference(_cfg()), ref, qry, device=CPU,
                        chunk=16).fused is False  # None on the CPU: the host loop
    for kw in (dict(max_template_switches=1), dict(prune_range=True),
               dict(allowed_primaries=(0,)), dict(allow_secondary_deletions=False)):
        eng = _engine(**kw)
        eng.align()
        assert eng.loop == "host", kw
        assert "fused" not in {e["route"] for e in eng.route_log}, kw
    host = _engine()
    host.fused = False
    assert host.align().cost == cost and host.loop == "host"


def test_round_cap_falls_back_to_the_host_loop(monkeypatch, caplog):
    """No pair of these needs a second round of reentry, so the cap is set
    to none: the fused loop raises, the host loop aligns the pair."""
    with pytest.raises(RuntimeError, match="converged"):
        BatchedTSAligner(config_from_reference(_cfg()), test_fused_rounds._pairs()[:1],
                         max_rounds=0, device=CPU, fused=True).align()
    want = _engine().align()
    monkeypatch.setattr(port_engine, "FUSED_MAX_ROUNDS", 0)
    eng = _engine()
    with caplog.at_level("WARNING"):
        res = eng.align()
    assert eng.loop == "host" and (res.cost, res.rounds) == (want.cost, want.rounds)
    assert "host loop" in caplog.text


def test_exception_in_the_fused_loop_propagates(monkeypatch):
    def broken(*a, **kw):
        raise ValueError("a fault of the fused loop")

    monkeypatch.setattr(fused_rounds, "_reentry_all_kinds", broken)
    with pytest.raises(ValueError, match="fault of the fused loop"):
        _engine().align()
