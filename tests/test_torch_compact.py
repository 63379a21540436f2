"""The compact live-column route of the port's reentry against the JAX
package's, exactly (tolerance 0).

``ops.modules.kind_sel_chunks`` gathers a kind's live entry columns into a
power-of-two bucket, runs the module scan and the assembly with separate
columns on the compact axis, and min-folds each column's slab at its own
j2 = e + s.  It is held against ``_kind_sel_chunks(gather=True)`` on the
sparsified fields of ``tests/test_compact_launch.py`` (every kind, seeds 3
and 4) and against the port's own chunked route; its batch form against the
JAX batch's ``_kind_sel_map_jit`` on stacked sparse fields of three pairs in
the 64 bucket, two of them poison-padded.  Then the route choice: the JAX
host loops, with ``JaxAligner._launch_compact`` and ``_kind_sel_map_jit``
wrapped to record what they launch, and the port's ``route_log`` must name
the same kinds, buckets and columns round by round, on inputs where the
compact route engages (asserted), with the same kept fields.
"""

import numpy as np
import pytest
import torch

from tsalign_tpu.alphabet import get_alphabet
from tsalign_tpu.config import TemplateSwitchConfig
from tsalign_tpu.jax_engine import JaxAligner
from tsalign_tpu.ops.jaxcommon import DEV_INF, to_device_costs
from tsalign_tpu.parallel import batch_ts as jax_batch
from tsalign_tpu_torch.convert import config_from_reference
from tsalign_tpu_torch.engine import TorchAligner
from tsalign_tpu_torch.ops.modules import kind_all_chunks, kind_sel_chunks
from tsalign_tpu_torch.parallel.batch_ts import BatchedTSAligner

from torch_util import one_torch_thread  # noqa: F401
from util import related_pair_scaled
import test_compact_launch

CPU = torch.device("cpu")


def _kind_key(km):
    return (km.spec.pk, km.spec.sk, km.spec.dk)


def _sparse_kind_fields(ja):
    """(JAX kind, its sparsified entry field, live columns) of every kind, as
    ``test_compact_route_equals_chunked_route`` builds them."""
    M = np.asarray(ja._sweep_host(np.asarray(to_device_costs(ja._root_seeds_host())), True))
    best = ja._target_cost(M) + 40
    budget = ja._sdel_budget(best)
    A = ja._pruned_entry(M, best)
    out = []
    for km in ja._build_kinds(budget):
        A_mod = A if km.spec.pk == 0 else A.T
        n_e = km.spec.n_anti + 1
        live_cols = [c for c in range(n_e) if A_mod[:, c].min() < int(DEV_INF)]
        if not live_cols:
            continue
        keep = live_cols[:: max(1, len(live_cols) // 3)][:3]
        A_sparse = np.full_like(A_mod, int(DEV_INF))
        A_sparse[:, keep] = A_mod[:, keep]
        out.append((km, A_sparse, np.asarray(keep, np.int64)))
    return budget, out


@pytest.mark.parametrize("seed", [3, 4])
def test_kind_sel_chunks_matches_jax_and_the_chunked_route(seed):
    import jax.numpy as jnp

    from tsalign_tpu.ops.jax_modules import _same_module_jit

    ja = test_compact_launch._mid_aligner(seed)
    budget, kinds = _sparse_kind_fields(ja)
    assert len(kinds) == 8
    port = TorchAligner(config_from_reference(ja.config), ja.ref, ja.qry, device=CPU,
                        chunk=8, keep_fields=False)
    port_kinds = {_kind_key(km): km for km in port._build_kinds(budget)}
    for jkm, A_sparse, e_live in kinds:
        km = port_kinds[_kind_key(jkm)]
        C = jkm.chunk
        assert km.chunk == C
        Kb = C
        while Kb < e_live.size:
            Kb *= 2
        B_pre = (_same_module_jit(jkm._fixed, st=jkm._static) if jkm.spec.same_seq
                 else jnp.zeros((1, 1), jnp.int32))
        want = np.array(ja._launch_compact(jkm, A_sparse, e_live, Kb, B_pre))
        e_sel = np.zeros(Kb, np.int64)
        e_sel[: e_live.size] = e_live
        PAD = max(0, -km.s_lo)
        OUTW = PAD + km.spec.n_anti + 1 + max(0, km.s_hi)
        A_dev = torch.from_numpy(np.ascontiguousarray(A_sparse))
        got = kind_sel_chunks([km], A_dev[None], e_sel[None], PAD, OUTW)[0]
        assert np.array_equal(got.numpy(), want), _kind_key(km)
        # the port's chunked route over the same sparse field
        n_e = km.spec.n_anti + 1
        bases = [min(e0, n_e - C) for e0 in range(0, n_e, C)]
        width = PAD + n_e + max(0, C - 1 + km.s_hi)
        (chunked,) = kind_all_chunks([km], A_dev[None], np.asarray([bases]), PAD, width)
        assert torch.equal(got[:, PAD : PAD + n_e], chunked[:, PAD : PAD + n_e]), _kind_key(km)


def _batch_pairs():
    """Three pairs of 50-64 bp in the 64 bucket: two are poison-padded."""
    al = get_alphabet("dna")
    rng = np.random.default_rng(0)
    return [related_pair_scaled(rng, al, n, 8) for n in (64, 57, 50)]


def test_kind_sel_chunks_batch_matches_kind_sel_map_jit():
    import jax.numpy as jnp

    cfg = TemplateSwitchConfig.default(get_alphabet("dna"))
    pairs = _batch_pairs()
    jbt = jax_batch.BatchedTSAligner(cfg, pairs, chunk=8)
    jbt._build_kind_sets(64)
    pbt = BatchedTSAligner(config_from_reference(cfg), pairs, chunk=8, device=CPU)
    pbt._build_kind_sets(64)
    B = len(pairs)
    rng = np.random.default_rng(5)
    padded_positive = 0
    for (jkm0, fixed_b, B_pre, _), (km0, kms, _) in zip(jbt._kind_state, pbt._kind_state):
        assert _kind_key(jkm0) == _kind_key(km0)
        n_e = km0.spec.n_anti + 1
        A = np.full((B, km0.spec.n_p + 1, n_e), int(DEV_INF), np.int32)
        e_sel = np.zeros((B, 8), np.int64)
        n_live = np.zeros(B, np.int64)
        for i, n_cols in enumerate((5, 2, 0)):  # one pair with no live column
            cols = np.sort(rng.choice(n_e, n_cols, replace=False))
            vals = rng.integers(0, 30, (km0.spec.n_p + 1, n_cols)).astype(np.int32)
            vals[rng.random(vals.shape) < 0.3] = int(DEV_INF)
            A[i][:, cols] = vals
            e_sel[i, :n_cols] = cols
            n_live[i] = n_cols
        PAD = max(0, -km0.s_lo)
        OUTW = PAD + n_e + max(0, km0.s_hi)
        want = np.array(jax_batch._kind_sel_map_jit(
            jnp.asarray(A), jnp.asarray(e_sel.astype(np.int32)), fixed_b, B_pre,
            st=jkm0._static._replace(separate_cols=True), PAD=PAD, OUTW=OUTW))
        A_dev = torch.from_numpy(A)
        for nl in (None, n_live):
            got = kind_sel_chunks(kms, A_dev, e_sel, PAD, OUTW, n_live=nl)
            assert np.array_equal(got.numpy(), want), (_kind_key(km0), nl)
        padded_positive += sum(1 for km in kms if km.padded
                               for plan in km.plans if plan.positive)
    # the poison-padded plans (_positive_padded) ran through separate_cols
    assert padded_positive > 0


def _same_fields(got, want):
    """The kept primary and reentry fields of two engine results are equal."""
    assert len(got.primary_fields) == len(want.primary_fields)
    assert len(got.reentry_fields) == len(want.reentry_fields)
    for x, y in zip(got.primary_fields + got.reentry_fields,
                    want.primary_fields + want.reentry_fields):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_single_pair_route_matches_jax(monkeypatch):
    """The host loop of one pair: the same compact launches (kind, bucket,
    live columns) round by round, and the same kept fields."""
    monkeypatch.delenv("TSALIGN_FUSED", raising=False)
    monkeypatch.setenv("TSALIGN_NO_FUSED", "1")
    al = get_alphabet("dna")
    cfg = TemplateSwitchConfig.default(al)
    ref, qry = related_pair_scaled(np.random.default_rng(0), al, 60, 8)
    jax_log, rounds = [], [0]
    launch, reentry = JaxAligner._launch_compact, JaxAligner._reentry

    def counting_reentry(self, *a, **kw):
        rounds[0] += 1
        return reentry(self, *a, **kw)

    def logging_launch(self, km, A_dev, e_live, Kb, B_pre):
        jax_log.append((rounds[0], _kind_key(km), Kb, tuple(int(e) for e in e_live)))
        return launch(self, km, A_dev, e_live, Kb, B_pre)

    monkeypatch.setattr(JaxAligner, "_reentry", counting_reentry)
    monkeypatch.setattr(JaxAligner, "_launch_compact", logging_launch)
    want = JaxAligner(cfg, ref, qry, chunk=8, keep_fields=True).align()
    eng = TorchAligner(config_from_reference(cfg), ref, qry, device=CPU, chunk=8,
                       keep_fields=True)
    got = eng.align()
    assert (got.cost, got.rounds) == (want.cost, want.rounds)
    port_log = [(e["round"], e["kind"], e["Kb"], e["e_live"]) for e in eng.route_log
                if e["route"] == "compact"]
    assert len(jax_log) > 0
    assert port_log == jax_log
    _same_fields(got, want)


def test_batch_route_matches_jax(monkeypatch):
    """The batch's host loop over two pairs of the 64 bucket (one padded):
    the same compact launches (kind, bucket, each pair's gathered columns)
    round by round, and the same kept fields."""
    monkeypatch.delenv("TSALIGN_FUSED", raising=False)
    monkeypatch.setenv("TSALIGN_NO_FUSED", "1")
    cfg = TemplateSwitchConfig.default(get_alphabet("dna"))
    pairs = _batch_pairs()[:2]
    jbt = jax_batch.BatchedTSAligner(cfg, pairs, chunk=8, keep_fields=True)
    jax_log, rounds = [], [0]
    reentry, sel_map = jax_batch.BatchedTSAligner._reentry_batch, jax_batch._kind_sel_map_jit

    def counting_reentry(self, *a, **kw):
        rounds[0] += 1
        return reentry(self, *a, **kw)

    def logging_sel_map(A_b, es_b, fixed_b, B_pre_b, *, st, PAD, OUTW):
        km0 = next(k for k, *_ in jbt._kind_state
                   if k._static._replace(separate_cols=True) == st)
        jax_log.append((rounds[0], _kind_key(km0), es_b.shape[1],
                        tuple(tuple(int(e) for e in row) for row in np.asarray(es_b))))
        return sel_map(A_b, es_b, fixed_b, B_pre_b, st=st, PAD=PAD, OUTW=OUTW)

    monkeypatch.setattr(jax_batch.BatchedTSAligner, "_reentry_batch", counting_reentry)
    monkeypatch.setattr(jax_batch, "_kind_sel_map_jit", logging_sel_map)
    want = jbt.align()
    pbt = BatchedTSAligner(config_from_reference(cfg), pairs, chunk=8, keep_fields=True,
                           device=CPU)
    got = pbt.align()
    assert [(r.cost, r.rounds) for r in got] == [(r.cost, r.rounds) for r in want]
    port_log = [(e["round"], e["kind"], e["Kb"], e["e_sel"]) for e in pbt.route_log
                if e["route"] == "compact"]
    assert len(jax_log) > 0
    assert port_log == jax_log
    for g, w in zip(got, want):
        _same_fields(g, w)
