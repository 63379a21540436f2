"""The port's primary sweeps against the JAX package (tolerance 0).

The same seeded tables and seeds go through the XLA sweep ``_sweep_jit``,
the Pallas kernels in interpret mode (both flankless ones, and the flanked
one), and the port's plain ``sweep_flankless_torch`` / ``sweep_flanked_torch``
(which the wrappers run for CPU tensors).  The port's side is built from the
port's own config (``convert.config_from_reference``).  The CUDA kernels
themselves are held against the plain versions on the card by
test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsalign_tpu.alphabet import get_alphabet
from tsalign_tpu.costs import INF
from tsalign_tpu.geometry import AlignmentRange
from tsalign_tpu.ops.jax_primary import JaxPrimarySweep, _sweep_jit
from tsalign_tpu.ops.jaxcommon import to_device_costs
from tsalign_tpu.ops.pallas_sweep import (sweep_pallas_flanked, sweep_pallas_flankless,
                                          sweep_pallas_flankless_tiled)
from tsalign_tpu_torch import _build
from tsalign_tpu_torch.convert import (config_from_reference, range_from_reference,
                                       tables_from_numpy)
from tsalign_tpu_torch.ops.primary import PrimarySweep
from tsalign_tpu_torch.ops.sweep import (sweep_flanked, sweep_flanked_torch, sweep_flankless,
                                         sweep_flankless_torch)

from torch_util import one_torch_thread  # noqa: F401
from util import random_config, random_pair


def _case(seed, max_len=12, min_len=3, ranged=False):
    rng = np.random.default_rng(900 + seed)
    al = get_alphabet("dna")
    cfg = random_config(rng, al, flanks=False)
    ref, qry = random_pair(rng, al, max_len=max_len, min_len=min_len)
    rng_obj = AlignmentRange(1, 1, len(ref), len(qry)) if ranged else None
    seeds = np.full((1, 3, len(ref) + 1, len(qry) + 1), INF, dtype=np.int64)
    seeds[0, 0, 0, 0] = 0
    for _ in range(5):
        g = int(rng.integers(0, 3))
        i = int(rng.integers(0, len(ref) + 1))
        j = int(rng.integers(0, len(qry) + 1))
        seeds[0, g, i, j] = int(rng.integers(0, 9))
    seeds = to_device_costs(seeds)
    seeds[0, 1, -1, 1] = 2**30 - 2  # an INF - 1 seed
    return cfg, ref, qry, rng_obj, seeds


@pytest.mark.parametrize("seed,ranged", [(0, False), (1, False), (2, True), (3, False)])
def test_sweep_matches_xla_and_pallas(seed, ranged):
    cfg, ref, qry, rng_obj, seeds = _case(seed, ranged=ranged)
    jw = JaxPrimarySweep(cfg, ref, qry, range_=rng_obj)
    pw = PrimarySweep(config_from_reference(cfg), ref, qry,
                      range_=range_from_reference(rng_obj))
    for a, b in zip(jw.flankless_inputs(), pw.flankless_inputs()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

    arrays = {"p": jw._rows["primary"], "l": jw._rows["left"], "r": jw._rows["right"],
              "ins": jw._ins}
    want_xla = np.asarray(_sweep_jit(jnp.asarray(seeds), arrays, L=0, R=0, climb=True))
    sub_rows, dd, io, ie = jw.flankless_inputs()
    seeds_r = jnp.asarray(seeds)[0].transpose(1, 0, 2)
    want_pallas = np.asarray(sweep_pallas_flankless(
        jnp.asarray(sub_rows), jnp.asarray(dd), seeds_r, jnp.asarray(io), jnp.asarray(ie),
        interpret=True)).transpose(1, 0, 2)[None]

    got = pw.sweep(torch.from_numpy(seeds))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want_xla)
    np.testing.assert_array_equal(got.numpy(), want_pallas)


@pytest.mark.parametrize("seed", range(2))
def test_sweep_matches_tiled_pallas_from_jax_tables(seed):
    """Fed the JAX package's own tables (tables_from_numpy), the port equals
    the row-tiled Pallas kernel over several row blocks."""
    cfg, ref, qry, _, seeds = _case(10 + seed, max_len=30, min_len=18)
    jw = JaxPrimarySweep(cfg, ref, qry)
    sub_rows, dd, io, ie = jw.flankless_inputs()
    seeds_r = np.ascontiguousarray(seeds[0].transpose(1, 0, 2))
    want = np.asarray(sweep_pallas_flankless_tiled(
        jnp.asarray(sub_rows), jnp.asarray(dd), jnp.asarray(seeds_r), jnp.asarray(io),
        jnp.asarray(ie), TB=8, interpret=True))
    t = tables_from_numpy(dict(sub_rows=sub_rows, dd=dd, seeds=seeds_r, io=io, ie=ie), "cpu")
    before = _build.launches["sweep_flankless"]
    got = sweep_flankless(t["sub_rows"], t["dd"], t["seeds"], t["io"], t["ie"])
    np.testing.assert_array_equal(got.numpy(), want)
    assert _build.launches["sweep_flankless"] == before  # the CPU path launches no kernel


def test_sweep_wrapper_checks_its_inputs():
    sub = torch.zeros((4, 3), dtype=torch.int32)
    dd = torch.zeros((4, 2), dtype=torch.int32)
    seeds = torch.zeros((4, 3, 3), dtype=torch.int32)
    io = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        sweep_flankless(sub.long(), dd, seeds, io, io)
    with pytest.raises(ValueError):
        sweep_flankless(sub, dd, seeds[:3], io, io)
    with pytest.raises(ValueError):
        sweep_flankless(sub, dd, seeds.transpose(1, 2), io, io)
    with pytest.raises(ValueError):
        sweep_flankless_torch(sub, dd, seeds, io, io - 1)  # negative extension


def _flanked_case(seed, L, R, ranged=False):
    """A random flanked config of the given flank lengths, a pair, and seeds
    with the root and extra random entries in every layer."""
    rng = np.random.default_rng(1900 + seed)
    al = get_alphabet("dna")
    cfg = random_config(rng, al, flanks=True)
    cfg.left_flank_length, cfg.right_flank_length = L, R
    ref, qry = random_pair(rng, al, max_len=12, min_len=3)
    rng_obj = AlignmentRange(1, 1, len(ref), len(qry)) if ranged else None
    F = L + R + 1
    seeds = np.full((F, 3, len(ref) + 1, len(qry) + 1), INF, dtype=np.int64)
    seeds[R, 0, 1 if ranged else 0, 1 if ranged else 0] = 0
    for fi in range(F):
        for _ in range(3):
            g = int(rng.integers(0, 3))
            i = int(rng.integers(0, len(ref) + 1))
            j = int(rng.integers(0, len(qry) + 1))
            seeds[fi, g, i, j] = int(rng.integers(0, 9))
    seeds = to_device_costs(seeds)
    seeds[F - 1, 1, -1, 1] = 2**30 - 2  # an INF - 1 seed
    return cfg, ref, qry, rng_obj, seeds


FLANKED_CASES = [(0, 2, 2, False), (1, 0, 1, False), (2, 1, 0, False), (3, 2, 1, True),
                 (4, 1, 2, False), (5, 0, 2, True)]


@pytest.mark.parametrize("climb", [True, False])
@pytest.mark.parametrize("seed,L,R,ranged", FLANKED_CASES)
def test_flanked_sweep_matches_xla_and_pallas(seed, L, R, ranged, climb):
    cfg, ref, qry, rng_obj, seeds = _flanked_case(seed, L, R, ranged)
    jw = JaxPrimarySweep(cfg, ref, qry, range_=rng_obj, allow_flank_climb=climb)
    pw = PrimarySweep(config_from_reference(cfg), ref, qry,
                      range_=range_from_reference(rng_obj), allow_flank_climb=climb)
    for a, b in zip(jw.flanked_inputs(), pw.flanked_inputs()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

    F = L + R + 1
    n_rows, Wq = len(ref) + 1, len(qry) + 1
    arrays = {"p": jw._rows["primary"], "l": jw._rows["left"], "r": jw._rows["right"],
              "ins": jw._ins}
    want_xla = np.asarray(_sweep_jit(jnp.asarray(seeds), arrays, L=L, R=R, climb=climb))
    subs, dd, io, ie = jw.flanked_inputs()
    seeds_r = np.ascontiguousarray(seeds.reshape(F * 3, n_rows, Wq).transpose(1, 0, 2))
    want_pallas_r = np.asarray(sweep_pallas_flanked(
        jnp.asarray(subs), jnp.asarray(dd), jnp.asarray(seeds_r), jnp.asarray(io),
        jnp.asarray(ie), L=L, R=R, climb=climb, interpret=True))
    want_pallas = want_pallas_r.transpose(1, 0, 2).reshape(F, 3, n_rows, Wq)
    np.testing.assert_array_equal(want_pallas, want_xla)

    # the engine's entry: (F, 3, n_r+1, n_q+1) in, the same out
    got = pw.sweep(torch.from_numpy(seeds))
    assert got.dtype == torch.int32 and got.shape == seeds.shape and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want_xla)

    # the wrapper and the plain version on the Pallas kernel's row-major layout
    t = tables_from_numpy(dict(subs=subs, dd=dd, seeds=seeds_r, io=io, ie=ie), "cpu")
    before = _build.launches["sweep_flanked"]
    for fn in (sweep_flanked, sweep_flanked_torch):
        got_r = fn(t["subs"], t["dd"], t["seeds"], t["io"], t["ie"], L=L, R=R, climb=climb)
        np.testing.assert_array_equal(got_r.numpy(), want_pallas_r)
    assert _build.launches["sweep_flanked"] == before  # the CPU path launches no kernel


def test_flanked_sweep_wrapper_checks_its_inputs():
    F, n_rows, Wq = 3, 4, 5
    subs = torch.zeros((3, n_rows, Wq), dtype=torch.int32)
    dd = torch.zeros((n_rows, 6), dtype=torch.int32)
    seeds = torch.zeros((n_rows, 3 * F, Wq), dtype=torch.int32)
    io = torch.zeros((3, Wq), dtype=torch.int32)
    kw = dict(L=1, R=1, climb=True)
    assert sweep_flanked(subs, dd, seeds, io, io, **kw).shape == seeds.shape
    planes = torch.zeros((3 * F, n_rows, Wq), dtype=torch.int32).permute(1, 0, 2)
    out = sweep_flanked(subs, dd, planes, io, io, **kw)
    assert out.stride() == planes.stride()  # plane-major in, plane-major out
    with pytest.raises(TypeError):
        sweep_flanked(subs, dd, seeds.long(), io, io, **kw)
    with pytest.raises(TypeError):
        sweep_flanked(subs.long(), dd, seeds, io, io, **kw)
    with pytest.raises(ValueError):
        sweep_flanked(subs, dd, seeds, io, io, L=2, R=1, climb=True)  # 3F planes expected
    with pytest.raises(ValueError):
        sweep_flanked(subs, dd[:, :2], seeds, io, io, **kw)
    with pytest.raises(ValueError):
        sweep_flanked(subs, dd, seeds.transpose(1, 2), io, io, **kw)
    with pytest.raises(ValueError):
        sweep_flanked(subs[:2], dd, seeds, io, io, **kw)
    with pytest.raises(ValueError):
        sweep_flanked(subs, dd, seeds, io, io, L=8, R=8, climb=True)  # above the layer cap
    with pytest.raises(ValueError):
        sweep_flanked_torch(subs, dd, seeds, io, io - 1, **kw)  # negative extension


def test_primary_sweep_checks_the_seed_shape():
    rng = np.random.default_rng(3)
    cfg = random_config(rng, get_alphabet("dna"), flanks=False)
    cfg.left_flank_length = 1
    pw = PrimarySweep(config_from_reference(cfg), np.zeros(3, np.int8), np.zeros(3, np.int8))
    assert pw.F == 2
    with pytest.raises(ValueError):
        pw.sweep(torch.zeros((1, 3, 4, 4), dtype=torch.int32))


@pytest.mark.parametrize("seed", range(4))
def test_flankless_engine_route_in_place_equals_copies(seed):
    """The flankless route hands the kernel the engine's plane-major field
    as a view; M is what the row-major copies around the launch gave."""
    cfg, ref, qry, _, seeds = _case(20 + seed, max_len=20, min_len=6)
    pw = PrimarySweep(config_from_reference(cfg), ref, qry)
    seeds_t = torch.from_numpy(seeds)
    sub_rows, dd, io, ie = pw._inputs_on(seeds_t.device)
    copied = sweep_flankless(sub_rows, dd, seeds_t[0].permute(1, 0, 2).contiguous(), io, ie)
    want = copied.permute(1, 0, 2).contiguous()[None]
    got = pw.sweep(seeds_t)
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got, want)
    # the wrapper itself: plane-major in, plane-major out, no copy of the seeds
    view = seeds_t[0].permute(1, 0, 2)
    out = sweep_flankless(sub_rows, dd, view, io, ie)
    assert out.stride() == view.stride() and torch.equal(out, copied)


def _random_flankless_inputs(seed, n_rows, Wq):
    """Seeded flankless inputs with DEV_INF and DEV_INF - 1 entries and
    negative seeds beside infinite ones (numpy, int32)."""
    rng = np.random.default_rng(4000 + seed)
    inf = 2**30 - 1

    def costs(shape, lo, hi, p_inf, p_inf1=0.0):
        x = rng.integers(lo, hi, size=shape).astype(np.int32)
        u = rng.random(shape)
        x[u < p_inf] = inf
        x[(u >= p_inf) & (u < p_inf + p_inf1)] = inf - 1
        return x

    sub = costs((n_rows, Wq), 0, 7, 0.05, 0.05)
    sub[0] = inf
    dd = costs((n_rows, 2), 0, 6, 0.05)
    seeds = costs((n_rows, 3, Wq), -40, 60, 0.7, 0.1)
    io = costs((Wq,), 0, 6, 0.05)
    ie = costs((Wq,), 0, 3, 0.05)
    return sub, dd, seeds, io, ie


@pytest.mark.parametrize("climb", [True, False])
@pytest.mark.parametrize("seed,n_rows,Wq", [(0, 1, 1), (1, 1, 9), (2, 7, 1), (3, 12, 17),
                                            (4, 30, 33)])
def test_flankless_plain_is_the_flanked_plain_without_flanks(seed, n_rows, Wq, climb):
    """`sweep_flankless_torch` equals `sweep_flanked_torch` at L = R = 0 on
    the same inputs, whatever the other two tables hold: one kernel may serve
    both sweeps."""
    sub, dd, seeds, io, ie = _random_flankless_inputs(seed, n_rows, Wq)
    rng = np.random.default_rng(seed)
    subs = rng.integers(0, 9, size=(3, n_rows, Wq)).astype(np.int32)
    subs[0] = sub
    dd6 = rng.integers(0, 9, size=(n_rows, 6)).astype(np.int32)
    dd6[:, :2] = dd
    io3 = rng.integers(0, 9, size=(3, Wq)).astype(np.int32)
    ie3 = rng.integers(0, 9, size=(3, Wq)).astype(np.int32)
    io3[0], ie3[0] = io, ie
    t = tables_from_numpy(dict(sub=sub, dd=dd, seeds=seeds, io=io, ie=ie, subs=subs, dd6=dd6,
                               io3=io3, ie3=ie3), "cpu")
    want = sweep_flankless_torch(t["sub"], t["dd"], t["seeds"], t["io"], t["ie"])
    got = sweep_flanked_torch(t["subs"], t["dd6"], t["seeds"], t["io3"], t["ie3"],
                              L=0, R=0, climb=climb)
    assert torch.equal(got, want)
    # and the flankless plain version equals the Pallas kernel on these inputs
    want_pallas = np.asarray(sweep_pallas_flankless(
        jnp.asarray(sub), jnp.asarray(dd), jnp.asarray(seeds), jnp.asarray(io),
        jnp.asarray(ie), interpret=True))
    np.testing.assert_array_equal(want.numpy(), want_pallas)
