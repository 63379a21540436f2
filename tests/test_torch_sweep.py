"""The port's flankless primary sweep against the JAX package (tolerance 0).

The same seeded tables and seeds go through the XLA sweep ``_sweep_jit``,
both flankless Pallas kernels in interpret mode, and the port's plain
``sweep_flankless_torch`` (which the wrapper runs for CPU tensors).  The CUDA
kernel itself is held against the plain version on the card by
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
from tsalign_tpu.ops.pallas_sweep import sweep_pallas_flankless, sweep_pallas_flankless_tiled
from tsalign_tpu_torch import _build
from tsalign_tpu_torch.convert import tables_from_numpy
from tsalign_tpu_torch.ops.primary import PrimarySweep
from tsalign_tpu_torch.ops.sweep import sweep_flankless, sweep_flankless_torch

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
    pw = PrimarySweep(cfg, ref, qry, range_=rng_obj)
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


def test_flanked_sweep_is_not_ported():
    rng = np.random.default_rng(3)
    cfg = random_config(rng, get_alphabet("dna"), flanks=False)
    cfg.left_flank_length = 1
    with pytest.raises(NotImplementedError):
        PrimarySweep(cfg, np.zeros(3, np.int8), np.zeros(3, np.int8))
