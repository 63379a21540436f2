"""The port's mesh paths against the JAX package's (tolerance 0).

The JAX side runs on the 8-virtual-device CPU mesh of tests/conftest.py, the
port's on ``parallel/mesh.py::Mesh`` over repeated CPU devices (a tensor on
the CPU runs every kernel wrapper's plain version):

  * the Mesh and its collectives, with repeated devices, the edge shard and
    the gather order;
  * ``parallel/sp_sweep.py``: the flankless sharded sweep against the JAX
    ``sp_sweep_flankless`` and the port's single-device sweep, the flanked
    one against the JAX ``sp_sweep_flanked`` and the numpy spec;
  * ``parallel/sp_reentry.py`` against the JAX ``sp_reentry`` and the port's
    unsharded chunked route;
  * ``parallel/batch.py``: ``BatchedGapAffine.costs`` and ``sharded_step``
    against the JAX ones on -1-padded batches (the float32 batch mean to
    rtol 1e-6, XLA's reduction order), and the kernel route's tables;
  * the batched engine's ``mesh=`` path: costs, rounds, every kept field and
    the traced alignments against the JAX ``mesh=`` path and the port's
    unsharded host loop; ``align_pairs(mesh=)`` on the batch fixture; a pair
    count the shard count does not divide, and ``fused=True`` with a mesh,
    both raise.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from tsalign_tpu.alphabet import get_alphabet
from tsalign_tpu.config import TemplateSwitchConfig as JaxConfig
from tsalign_tpu.jax_engine import JaxAligner
from tsalign_tpu.ops.jax_primary import JaxPrimarySweep
from tsalign_tpu.ops.jaxcommon import DEV_INF, to_device_costs
from tsalign_tpu.parallel import batch as jax_batch
from tsalign_tpu.parallel import batch_ts as jax_batch_ts
from tsalign_tpu.parallel.sp_reentry import sp_reentry as jax_sp_reentry
from tsalign_tpu.parallel.sp_sweep import sp_sweep_flanked as jax_sp_sweep_flanked
from tsalign_tpu.parallel.sp_sweep import sp_sweep_flankless as jax_sp_sweep_flankless
from tsalign_tpu_torch.config import TemplateSwitchConfig
from tsalign_tpu_torch.convert import config_from_reference
from tsalign_tpu_torch.engine import TorchAligner
from tsalign_tpu_torch.ops.primary import PrimarySweep
from tsalign_tpu_torch.ops.primary_sweep import PrimarySweep as NumpySweep
from tsalign_tpu_torch.parallel import batch as port_batch
from tsalign_tpu_torch.parallel import batch_ts as port_batch_ts
from tsalign_tpu_torch.parallel.mesh import (Mesh, all_gather, pmean, pmin, ppermute_right,
                                             shard_blocks)
from tsalign_tpu_torch.ops.modules import fold_kind_cells, kind_all_chunks
from tsalign_tpu_torch.parallel import sp_reentry as sp_reentry_module
from tsalign_tpu_torch.parallel.sp_sweep import sp_sweep_flanked, sp_sweep_flankless

from torch_util import one_torch_thread  # noqa: F401
from util import random_config, random_pair, related_pair_scaled

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def jax_mesh(D, axis):
    devs = jax.devices()
    if len(devs) < D:
        pytest.skip(f"needs {D} JAX devices")
    return JaxMesh(np.array(devs[:D]), (axis,))


def cpu_mesh(D, axis):
    return Mesh(["cpu"] * D, (axis,))


def test_mesh_and_its_collectives():
    mesh = cpu_mesh(3, "sp")
    assert mesh.shape["sp"] == 3 and mesh.devices == (torch.device("cpu"),) * 3
    xs = [torch.tensor([[10 * d + 1, 10 * d + 2]], dtype=torch.int32) for d in range(3)]
    recv = ppermute_right(xs, mesh)
    assert torch.equal(recv[0], torch.full((1, 2), DEV_INF, dtype=torch.int32))  # the edge shard
    assert all(torch.equal(recv[d], xs[d - 1]) for d in (1, 2))
    gathered = all_gather(xs, mesh)
    assert len(gathered) == 3
    for g in gathered:
        assert torch.equal(g, torch.stack(xs))  # shard order
    ys = [torch.tensor([5, 1, 9]), torch.tensor([2, 7, 9]), torch.tensor([4, 4, 0])]
    for m in pmin(ys, mesh):
        assert torch.equal(m, torch.tensor([2, 1, 0]))
    for m in pmean([torch.tensor([1, 2]), torch.tensor([3, 4]), torch.tensor([5, 10])], mesh):
        assert m.dtype == torch.float32 and float(m) == float(np.float32(25 / 6))
    assert shard_blocks(mesh, 6, "sp") == [(slice(0, 2), torch.device("cpu")),
                                           (slice(2, 4), torch.device("cpu")),
                                           (slice(4, 6), torch.device("cpu"))]
    with pytest.raises(ValueError, match="length 7 .* 3 shards"):
        shard_blocks(mesh, 7, "sp")
    with pytest.raises(ValueError, match="no axis 'data'"):
        shard_blocks(mesh, 6, "data")
    # a device that is not present raises; nothing moves to the CPU
    with pytest.raises(ValueError, match="cuda"):
        Mesh(["cpu", f"cuda:{torch.cuda.device_count()}"], ("sp",))
    with pytest.raises(ValueError, match="one axis"):
        Mesh(["cpu"], ("a", "b"))


@pytest.mark.parametrize("n", [1, 2, 7, 300])
def test_sharded_chain_aggregates_equal_the_serial_recurrence(n):
    """A block's chain and saturated extension sums (`_chain_with_prefix`)
    against the serial clamped recurrence, with DEV_INF among the
    candidates and the extensions (an int32 sum of three of them wraps)."""
    from tsalign_tpu_torch.parallel.sp_sweep import _chain_with_prefix

    g = torch.Generator().manual_seed(n)
    for _ in range(20):
        cand = torch.randint(0, 50, (n,), generator=g, dtype=torch.int32)
        ext = torch.randint(0, 5, (n,), generator=g, dtype=torch.int32)
        cand[torch.rand(n, generator=g) < 0.5] = DEV_INF
        ext[torch.rand(n, generator=g) < 0.2] = DEV_INF
        c, e = _chain_with_prefix(cand, ext)
        d, s = DEV_INF, 0
        for t in range(n):
            d = min(int(cand[t]), min(d + int(ext[t]), DEV_INF))
            s = min(s + int(ext[t]), DEV_INF)
            assert (int(c[t]), int(e[t])) == (d, s)


@pytest.mark.parametrize("n_q,D", [(5, 8), (17, 3), (64, 2)])
def test_sp_sweep_flankless_matches_jax_and_the_single_device_sweep(n_q, D):
    """As tests/test_parallel.py: a random config, the root seed and three
    extra random seeds (mid-field entries), D > n_q + 1 included."""
    rng = np.random.default_rng(n_q)
    al = get_alphabet("dna")
    cfg = random_config(rng, al, flanks=False)
    n_r = int(rng.integers(3, 40))
    ref = rng.integers(0, 4, size=n_r).astype(np.int8)
    qry = rng.integers(0, 4, size=n_q).astype(np.int8)
    seeds = np.full((1, 3, n_r + 1, n_q + 1), int(DEV_INF), np.int32)
    seeds[0, 0, 0, 0] = 0
    for _ in range(3):
        seeds[0, 0, int(rng.integers(0, n_r + 1)), int(rng.integers(0, n_q + 1))] = int(
            rng.integers(0, 9))
    want = np.asarray(jax_sp_sweep_flankless(JaxPrimarySweep(cfg, ref, qry), seeds[0],
                                             jax_mesh(D, "sp")))
    sweep = PrimarySweep(config_from_reference(cfg), ref, qry)
    got = sp_sweep_flankless(sweep, seeds[0], cpu_mesh(D, "sp"))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), sweep.sweep(torch.from_numpy(seeds))[0].numpy())


@pytest.mark.parametrize("trial,D", [(0, 8), (1, 3)])
def test_sp_sweep_flanked_matches_jax_and_the_numpy_spec(trial, D):
    """As tests/test_parallel.py: random flanked configs with random extra
    seeds in every layer and gap plane."""
    INF = 2**62
    rng = np.random.default_rng(321 + trial)
    al = get_alphabet("dna")
    cfg = random_config(rng, al, flanks=True)
    cfg.left_flank_length = int(rng.integers(1, 3))
    cfg.right_flank_length = int(rng.integers(0, 3))
    F = cfg.left_flank_length + cfg.right_flank_length + 1
    ref, qry = random_pair(rng, al, max_len=14, min_len=5)
    seeds = np.full((F, 3, len(ref) + 1, len(qry) + 1), INF, np.int64)
    seeds[F - 1, 0, 0, 0] = 0
    for _ in range(4):
        seeds[int(rng.integers(0, F)), int(rng.integers(0, 3)), int(rng.integers(0, len(ref) + 1)),
              int(rng.integers(0, len(qry) + 1))] = int(rng.integers(0, 9))
    dev_seeds = to_device_costs(seeds)
    want = np.asarray(jax_sp_sweep_flanked(JaxPrimarySweep(cfg, ref, qry), dev_seeds,
                                           jax_mesh(D, "sp")))
    pcfg = config_from_reference(cfg)
    got = sp_sweep_flanked(PrimarySweep(pcfg, ref, qry), dev_seeds, cpu_mesh(D, "sp"))
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)
    spec = NumpySweep(pcfg, ref, qry).sweep(seeds)
    np.testing.assert_array_equal(np.where(got >= 2**29, INF, got.astype(np.int64)), spec)


@pytest.fixture(scope="module")
def first_round():
    """The default config on a 70 bp planted pair, chunk 8, at the first
    round with every kind live (the budget of best + 40, as
    tests/test_parallel.py) and every chunk live (the entry field unpruned):
    the JAX engine, its kinds and the entry field, the port's engine and its
    kinds, and the unsharded chunked route (``kind_all_chunks`` over every
    chunk, ``fold_kind_cells``): each kind's slab and the folded field."""
    rng = np.random.default_rng(9)
    al = get_alphabet("dna")
    cfg = JaxConfig.default(al)
    ref, qry = related_pair_scaled(rng, al, 70, 8)
    ja = JaxAligner(cfg, ref, qry, chunk=8, keep_fields=False)
    M = ja._sweep_host(np.asarray(to_device_costs(ja._root_seeds_host())), True)
    best = ja._target_cost(M) + 40
    ja._last_budget = ja._sdel_budget(best)
    jax_kinds = ja._build_kinds(ja._last_budget)
    A = np.asarray(M)[-1].min(axis=0).astype(np.int32)
    assert (A < DEV_INF).all()
    eng = TorchAligner(config_from_reference(cfg), ref, qry, device="cpu", chunk=8,
                       keep_fields=False)
    kinds = eng._build_kinds(ja._last_budget)
    assert ([(k.spec.pk, k.spec.sk, k.spec.dk) for k in kinds]
            == [(k.spec.pk, k.spec.sk, k.spec.dk) for k in jax_kinds])
    slabs, R = [], torch.full(A.shape, DEV_INF, dtype=torch.int32)
    for km in kinds:
        spec = km.spec
        A_mod = torch.from_numpy(np.ascontiguousarray(A if spec.pk == 0 else A.T))
        n_e, C = spec.n_anti + 1, km.chunk
        PAD = max(0, -km.s_lo)
        width = PAD + n_e + max(0, C - 1 + km.s_hi)
        bases = np.asarray([[min(e0, n_e - C) for e0 in range(0, n_e, C)]])
        (slab,) = kind_all_chunks([km], A_mod[None], bases, PAD, width)
        slabs.append(slab.numpy())
        R = fold_kind_cells(R, slab, spec.n_anti_real, PAD=PAD, n_anti=spec.n_anti,
                            transpose=spec.pk == 1)
    return ja, jax_kinds, A, eng, kinds, slabs, R.numpy()


@pytest.mark.parametrize("D", [2, 8])
def test_sp_reentry_matches_jax_and_the_unsharded_chunked_route(first_round, D, monkeypatch):
    ja, jax_kinds, A, eng, kinds, slabs, unsharded = first_round
    want = jax_sp_reentry(ja, A, jax_kinds, jax_mesh(D, "sp"))
    got_slabs = []
    inner = sp_reentry_module.sp_reentry_kind
    monkeypatch.setattr(sp_reentry_module, "sp_reentry_kind",
                        lambda *a, **kw: got_slabs.append(inner(*a, **kw)) or got_slabs[-1])
    got = sp_reentry_module.sp_reentry(eng, A, kinds, cpu_mesh(D, "sp"))
    assert isinstance(got, np.ndarray) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, unsharded)
    assert len(got_slabs) == len(slabs)
    for g, w in zip(got_slabs, slabs):  # every kind's slab, every chunk in it
        np.testing.assert_array_equal(g, w)


def _padded_batch(rng, al, n_pairs):
    letters = "ACGT"
    seqs = [("".join(letters[c] for c in rng.integers(0, 4, size=int(rng.integers(0, 30)))),
             "".join(letters[c] for c in rng.integers(0, 4, size=int(rng.integers(1, 30)))))
            for _ in range(n_pairs)]
    return (jax_batch.encode_batch(al, [r for r, _ in seqs]),
            jax_batch.encode_batch(al, [q for _, q in seqs], pad_to=33))


@pytest.mark.parametrize("flanks,D", [(False, 2), (True, 4)])
def test_batched_gap_affine_matches_jax(flanks, D):
    """costs and sharded_step on -1-padded batches under a random config
    (the gap-affine core ignores flanks); the kernel route's tables
    (`sweep_gap_affine`, the flankless sweep's plain version here) equal
    the JAX function too, and for a pair without padding they are
    PrimarySweep.flankless_inputs'."""
    rng = np.random.default_rng(40 + D)
    al = get_alphabet("dna")
    cfg = random_config(rng, al, flanks=flanks)
    refs, qrys = _padded_batch(rng, al, 8)
    want_bg = jax_batch.BatchedGapAffine(cfg)
    want = want_bg.costs(refs, qrys)
    want_c, want_mean = want_bg.sharded_step(jax_mesh(D, "data"), refs, qrys)

    pcfg = config_from_reference(cfg)
    bg = port_batch.BatchedGapAffine(pcfg, device="cpu")
    got = bg.costs(refs, qrys)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    tables = bg.tables("cpu")
    kernel_route = port_batch.sweep_gap_affine(bg.A, *tables, torch.from_numpy(refs),
                                               torch.from_numpy(qrys))
    np.testing.assert_array_equal(kernel_route.numpy(), want)
    got_c, got_mean = bg.sharded_step(cpu_mesh(D, "data"), refs, qrys)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert got_mean.dtype == torch.float32
    np.testing.assert_allclose(float(got_mean), float(want_mean), rtol=1e-6)

    # the kernel route's layout is the flankless sweep's
    ref, qry = refs[0][refs[0] >= 0], qrys[0][qrys[0] >= 0]
    sweep = PrimarySweep(pcfg, ref.astype(np.int8), qry.astype(np.int8))
    sub_rows, dd, io, ie = sweep.flankless_inputs()
    sub, go, ge = (t.numpy() for t in tables)
    want_sub = np.full_like(sub_rows, DEV_INF)
    want_sub[1:, : len(qry)] = sub[ref[:, None], qry[None, :]]
    np.testing.assert_array_equal(sub_rows, want_sub)
    np.testing.assert_array_equal(dd[1:], np.stack([go[ref], ge[ref]], axis=1))
    np.testing.assert_array_equal(io[:-1], go[qry])
    np.testing.assert_array_equal(ie[:-1], ge[qry])


def _small_pairs(rng, al, n_pairs):
    return [related_pair_scaled(rng, al, int(rng.integers(20, 33)), 6) for _ in range(n_pairs)]


def _assert_results_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.cost, g.rounds) == (w.cost, w.rounds)
        assert len(g.primary_fields) == len(w.primary_fields)
        assert len(g.reentry_fields) == len(w.reentry_fields)
        for a, b in zip(g.primary_fields + g.reentry_fields, w.primary_fields + w.reentry_fields):
            np.testing.assert_array_equal(a, b)


def test_batched_engine_mesh_path_matches_jax_and_the_unsharded_host_loop():
    """Four small pairs on a 2-shard data mesh: per pair the cost, the
    rounds, every kept primary and reentry field, and the traced
    alignment."""
    rng = np.random.default_rng(710)
    al = get_alphabet("dna")
    cfg = random_config(rng, al, flanks=False)
    pairs = _small_pairs(rng, al, 4)
    jmesh, mesh = jax_mesh(2, "data"), cpu_mesh(2, "data")
    want_bt = jax_batch_ts.BatchedTSAligner(cfg, pairs, chunk=16, keep_fields=True)
    want = want_bt.align(mesh=jmesh)
    pcfg = config_from_reference(cfg)
    got_bt = port_batch_ts.BatchedTSAligner(pcfg, pairs, chunk=16, keep_fields=True,
                                            device="cpu")
    got = got_bt.align(mesh=mesh)
    _assert_results_equal(got, want)
    assert all(e["route"] == "chunked" for e in got_bt.route_log)
    host = port_batch_ts.BatchedTSAligner(pcfg, pairs, chunk=16, keep_fields=True,
                                          device="cpu").align()
    _assert_results_equal(got, host)
    np.testing.assert_array_equal(
        port_batch_ts.BatchedTSAligner(pcfg, pairs, chunk=16, device="cpu").costs(mesh=mesh),
        jax_batch_ts.BatchedTSAligner(cfg, pairs, chunk=16).costs(mesh=jmesh))

    traced = port_batch_ts.BatchedTSAligner(pcfg, pairs, chunk=16, device="cpu")
    traced_want = jax_batch_ts.BatchedTSAligner(cfg, pairs, chunk=16)
    for (cg, ag), (cw, aw) in zip(traced.align_with_traceback(mesh=mesh),
                                  traced_want.align_with_traceback(mesh=jmesh)):
        assert cg == cw and str(ag) == str(aw)


def test_align_pairs_mesh_matches_the_batch_fixture():
    """The 64 bucket's two pairs of tests/fixtures/torch_port_batch_pairs.json
    (recorded from the JAX align_pairs) through align_pairs(mesh=) on a
    2-shard data mesh: cost and CIGAR equal the fixture's."""
    with open(os.path.join(FIXTURES, "torch_port_batch_pairs.json")) as f:
        fixture = [p for p in json.load(f)["pairs"] if len(p["reference"]) <= 64]
    assert len(fixture) == 2
    cfg = TemplateSwitchConfig.default(get_alphabet("dna-n"))
    records = port_batch_ts.align_pairs(cfg, [(p["reference"], p["query"]) for p in fixture],
                                        device="cpu", mesh=cpu_mesh(2, "data"))
    for p, rec in zip(fixture, records):
        assert (rec.result.cost, rec.cigar()) == (p["cost"], p["cigar"])


def test_a_pair_count_the_shards_do_not_divide_raises_as_in_jax():
    """3 pairs on a 2-shard data mesh: the JAX package's device_put raises
    ValueError, and so does the port, naming the counts."""
    rng = np.random.default_rng(711)
    al = get_alphabet("dna")
    cfg = random_config(rng, al, flanks=False)
    pairs = _small_pairs(rng, al, 3)
    with pytest.raises(ValueError):
        jax_batch_ts.BatchedTSAligner(cfg, pairs, chunk=16).costs(mesh=jax_mesh(2, "data"))
    with pytest.raises(ValueError, match="length 3 .* 2 shards"):
        port_batch_ts.BatchedTSAligner(config_from_reference(cfg), pairs, chunk=16,
                                       device="cpu").costs(mesh=cpu_mesh(2, "data"))
    refs, qrys = _padded_batch(rng, al, 3)
    with pytest.raises(ValueError):
        jax_batch.BatchedGapAffine(cfg).sharded_step(jax_mesh(2, "data"), refs, qrys)
    with pytest.raises(ValueError, match="length 3 .* 2 shards"):
        port_batch.BatchedGapAffine(config_from_reference(cfg), device="cpu").sharded_step(
            cpu_mesh(2, "data"), refs, qrys)


def test_fused_loop_with_a_mesh_raises():
    rng = np.random.default_rng(712)
    al = get_alphabet("dna")
    pcfg = config_from_reference(random_config(rng, al, flanks=False))
    pairs = _small_pairs(rng, al, 2)
    bt = port_batch_ts.BatchedTSAligner(pcfg, pairs, chunk=16, device="cpu", fused=True)
    with pytest.raises(ValueError, match="fused=True takes no mesh"):
        bt.align(mesh=cpu_mesh(2, "data"))
    with pytest.raises(ValueError, match="fused=True takes no mesh"):
        port_batch_ts.align_pairs(pcfg, [("ACGTACGTAC", "ACGTTCGTAC")] * 2, device="cpu",
                                  fused=True, mesh=cpu_mesh(2, "data"))
