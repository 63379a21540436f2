"""The port's int32 (min,+) primitives against ops/jaxcommon.py (tolerance 0).

Seeded numpy inputs, including DEV_INF and DEV_INF - 1 entries, go through
the JAX function and its torch counterpart and must agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsalign_tpu.ops import jaxcommon as jc
from tsalign_tpu_torch.ops import common as tc

from torch_util import one_torch_thread  # noqa: F401

INF = tc.DEV_INF


def _costs(rng, shape, lo, hi, p_inf=0.1, p_inf1=0.05):
    x = rng.integers(lo, hi, size=shape).astype(np.int32)
    u = rng.random(shape)
    x[u < p_inf] = INF
    x[(u >= p_inf) & (u < p_inf + p_inf1)] = INF - 1
    return x


def _serial_chain(cand, ext, reverse):
    """The serial recurrence D[t] = min(cand[t], min(D[t-1] + ext[t], INF))."""
    c = cand.astype(np.int64)
    e = ext.astype(np.int64)
    if reverse:
        c, e = c[..., ::-1], e[..., ::-1]
    d = np.empty_like(c)
    prev = np.full(c.shape[:-1], INF, dtype=np.int64)
    for t in range(c.shape[-1]):
        prev = np.minimum(c[..., t], np.minimum(prev + e[..., t], INF))
        d[..., t] = prev
    return (d[..., ::-1] if reverse else d).astype(np.int32)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("reverse", [False, True])
def test_minplus_scan_matches_jax(seed, reverse):
    rng = np.random.default_rng(40 + seed)
    cand = _costs(rng, (5, 4, 37), 0, 60)
    ext = _costs(rng, (5, 4, 37), 0, 5)
    want = np.asarray(jc.minplus_scan(jnp.asarray(cand), jnp.asarray(ext), reverse=reverse))
    got = tc.minplus_scan(torch.from_numpy(cand), torch.from_numpy(ext), reverse=reverse)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _serial_chain(cand, ext, reverse))


@pytest.mark.parametrize("reverse", [False, True])
def test_minplus_scan_is_the_serial_chain_for_negative_candidates(reverse):
    """With negative candidates and infinite extension edges the port still
    equals the serial recurrence that the CUDA kernels run."""
    rng = np.random.default_rng(7)
    cand = _costs(rng, (6, 41), -30, 30)
    ext = _costs(rng, (6, 41), 0, 4, p_inf=0.3)
    got = tc.minplus_scan(torch.from_numpy(cand), torch.from_numpy(ext), reverse=reverse)
    np.testing.assert_array_equal(got.numpy(), _serial_chain(cand, ext, reverse))


@pytest.mark.parametrize("dim", [2, 0, 1])
@pytest.mark.parametrize("reverse", [False, True])
def test_minplus_scan_serial_form_over_many_chains(dim, reverse, monkeypatch):
    """Over SERIAL_CHAINS chains side by side or more the scan runs the
    serial recurrence itself: equal to the numpy chain and to the
    log-doubling form, along any axis."""
    rng = np.random.default_rng(50)
    cand = _costs(rng, (24, 32, 29), -3, 60)  # 768 chains of 29
    ext = _costs(rng, (24, 32, 29), 0, 5, p_inf=0.05)
    assert cand.size >= tc.SERIAL_CHAINS * cand.shape[-1]
    want = np.moveaxis(_serial_chain(cand, ext, reverse), 2, dim)
    c, e = (torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, 2, dim))) for x in (cand, ext))
    got = tc.minplus_scan(c, e, dim=dim, reverse=reverse)
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    monkeypatch.setattr(tc, "SERIAL_CHAINS", 10**9)  # the log-doubling form
    np.testing.assert_array_equal(tc.minplus_scan(c, e, dim=dim, reverse=reverse).numpy(), want)


def test_minplus_scan_rejects_negative_extension():
    cand = torch.zeros(8, dtype=torch.int32)
    ext = torch.zeros(8, dtype=torch.int32)
    ext[3] = -1
    with pytest.raises(ValueError):
        tc.check_extension("minplus_scan", ext)
    tc.check_extension("minplus_scan", ext.clamp_min(0))


@pytest.mark.parametrize("w", [1, 2, 5, 16])
def test_sliding_min_start_matches_jax(w):
    rng = np.random.default_rng(w)
    x = _costs(rng, (3, 4, 29), -5, 50)
    want = np.asarray(jc.sliding_min_start(jnp.asarray(x), w, axis=-1))
    got = tc.sliding_min_start(torch.from_numpy(x), w, dim=-1)
    np.testing.assert_array_equal(got.numpy(), want)
    want0 = np.asarray(jc.sliding_min_start(jnp.asarray(x), w, axis=0))
    np.testing.assert_array_equal(tc.sliding_min_start(torch.from_numpy(x), w, dim=0).numpy(), want0)


@pytest.mark.parametrize("reverse", [False, True])
def test_cummin_and_saturating_adds_match_jax(reverse):
    rng = np.random.default_rng(11)
    x = _costs(rng, (4, 23), -5, 50)
    y = _costs(rng, (4, 23), -1, 9)
    z = _costs(rng, (4, 23), 0, 9)
    np.testing.assert_array_equal(
        tc.cummin(torch.from_numpy(x), dim=-1, reverse=reverse).numpy(),
        np.asarray(jc.cummin(jnp.asarray(x), axis=-1, reverse=reverse)),
    )
    tx, ty, tz = (torch.from_numpy(a) for a in (x, y, z))
    np.testing.assert_array_equal(tc.sat_add(tx, ty).numpy(),
                                  np.asarray(jc.sat_add(jnp.asarray(x), jnp.asarray(y))))
    np.testing.assert_array_equal(
        tc.sat_add3(tx, ty, tz).numpy(),
        np.asarray(jc.sat_add3(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))),
    )


def test_host_cost_maps_match_jax():
    from tsalign_tpu.costs import INF as HOST_INF

    x = np.array([0, 5, 2**29 - 1, 2**29, 2**31, HOST_INF], dtype=np.int64)
    np.testing.assert_array_equal(tc.to_device_costs(x), jc.to_device_costs(x))
    d = jc.to_device_costs(x)
    np.testing.assert_array_equal(tc.from_device_costs(d), jc.from_device_costs(d))
    tc.validate_magnitudes(10, 100)
    with pytest.raises(OverflowError):
        tc.validate_magnitudes(2**20, 2**10)
