"""The port's TSM kind modules against the JAX package (tolerance 0).

  * the cross-kind module scan against ``_module_scan_xla`` and the Pallas
    kernel ``module_scan_pallas`` in interpret mode;
  * the kind tables against ``JaxKindModule._fixed``, array by array, and
    the same-sequence scan against ``_same_module_jit``;
  * the chunk driver (module + assembly + min-fold) and the fold into the
    reentry field against ``_kind_all_chunks`` + ``_fold_kind_cells``;
  * the reentry field's independence of the chunk size;
  * the arithmetic of the kernel's skipping mode (no card needed):
    ``dead_state_threshold`` is sound on the plain version's results, is off
    when it would overflow, and ``equal_mod_inf`` compares as it says.
The CUDA kernel itself is held against the plain version on the card by
test_torch_kernels.py.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsalign_tpu.alphabet import get_alphabet
from tsalign_tpu.config import TemplateSwitchConfig
from tsalign_tpu.ops.jax_modules import (
    JaxKindModule,
    _fold_kind_cells,
    _kind_all_chunks,
    _module_scan_xla,
    _same_module_jit,
)
from tsalign_tpu.ops.pallas_module import module_scan_pallas
from tsalign_tpu.ops.tsm_modules import make_kind_spec
from tsalign_tpu_torch.convert import config_from_reference
from tsalign_tpu_torch.ops import tsm_modules as port_tsm
from tsalign_tpu_torch.ops.common import (DEV_INF, DEV_INF_THRESH, dead_state_threshold,
                                          equal_mod_inf, sat_add)
from tsalign_tpu_torch.ops.module_scan import module_scan, module_scan_diag
from tsalign_tpu_torch.ops.modules import (
    KindModule,
    fold_kind_cells,
    kind_all_chunks,
    module_scan_torch,
)

from torch_util import one_torch_thread  # noqa: F401
from util import random_config, related_pair


def _scan_inputs(rng, NB, C, W, L, A):
    """Seeded module-scan inputs with DEV_INF and DEV_INF - 1 entries and a
    -1 in the LUT (the tie-break bonus).  Finite seeds >= L keep every value
    nonnegative, where the JAX package's chain orders and the port's serial
    chain agree bit for bit (ops/common.py)."""
    seedT = rng.integers(L, L + 20, size=(NB, C, W)).astype(np.int32)
    seedT[rng.random(seedT.shape) < 0.5] = DEV_INF
    lut = rng.integers(-1, 7, size=(A, C, W)).astype(np.int32)
    lut[A - 1] = DEV_INF
    lut[rng.random(lut.shape) < 0.05] = DEV_INF - 1
    sdo = rng.integers(0, 6, size=(C, W)).astype(np.int32)
    sde = rng.integers(0, 3, size=(C, W)).astype(np.int32)
    sdo[rng.random(sdo.shape) < 0.1] = DEV_INF
    sde[rng.random(sde.shape) < 0.1] = DEV_INF
    pchar = rng.integers(0, A, size=(L, NB)).astype(np.int32)
    pmask = np.where(rng.random((L, NB)) < 0.2, DEV_INF, 0).astype(np.int32)
    pgo = rng.integers(-1, 6, size=A).astype(np.int32)
    pge = rng.integers(-1, 3, size=A).astype(np.int32)
    io = np.minimum(pgo[pchar].astype(np.int64) + pmask, DEV_INF).astype(np.int32)
    ie = np.minimum(pge[pchar].astype(np.int64) + pmask, DEV_INF).astype(np.int32)
    return (seedT, lut, sdo, sde, pchar, pmask, io, ie), (pgo, pge)


@pytest.mark.parametrize("fwd", [True, False])
@pytest.mark.parametrize("allow_sdel", [True, False])
@pytest.mark.parametrize("shape", [(10, 4, 33, 6), (12, 8, 17, 8), (3, 1, 5, 1)])
def test_module_scan_matches_xla_and_pallas(fwd, allow_sdel, shape):
    NB, C, W, L = shape
    A = 5
    rng = np.random.default_rng(NB * 100 + C * 10 + W + int(fwd) + 2 * int(allow_sdel))
    args, (pgo, pge) = _scan_inputs(rng, NB, C, W, L, A)
    seedT, lut, sdo, sde, pchar, pmask, io, ie = args
    st = SimpleNamespace(L=L, W=W, dk=0 if fwd else 1, allow_sdel=allow_sdel, same_seq=False)
    fixed = {"pchar_l": jnp.asarray(pchar), "pmask_l": jnp.asarray(pmask),
             "pgo": jnp.asarray(pgo), "pge": jnp.asarray(pge)}
    want_xla = np.asarray(_module_scan_xla(jnp.asarray(seedT), jnp.asarray(lut),
                                           jnp.asarray(sdo), jnp.asarray(sde), fixed, st=st))
    want_pallas = np.asarray(module_scan_pallas(
        *[jnp.asarray(a) for a in args], L=L, A=A, fwd=fwd, allow_sdel=allow_sdel,
        interpret=True))
    got = module_scan(*[torch.from_numpy(a) for a in args], fwd=fwd, allow_sdel=allow_sdel)
    assert got.shape == (L + 1, NB, C) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want_xla)
    np.testing.assert_array_equal(got.numpy(), want_pallas)


@pytest.mark.parametrize("fwd", [True, False])
@pytest.mark.parametrize("allow_sdel", [True, False])
def test_module_scan_pair_axis_matches_xla_per_set(fwd, allow_sdel):
    """The wrapper's pair axis (P sets of one shape) on the CPU: each set
    equals ``_module_scan_xla`` on its own."""
    NB, C, W, L, A = 7, 3, 21, 5, 5
    rng = np.random.default_rng(90 + int(fwd) + 2 * int(allow_sdel))
    sets = [_scan_inputs(rng, NB, C, W, L, A) for _ in range(3)]
    stacked = [torch.from_numpy(np.stack(xs)) for xs in zip(*(a for a, _ in sets))]
    got = module_scan(*stacked, fwd=fwd, allow_sdel=allow_sdel)
    assert got.shape == (3, L + 1, NB, C)
    for z, (args, (pgo, pge)) in enumerate(sets):
        seedT, lut, sdo, sde, pchar, pmask, _, _ = args
        st = SimpleNamespace(L=L, W=W, dk=0 if fwd else 1, allow_sdel=allow_sdel, same_seq=False)
        fixed = {"pchar_l": jnp.asarray(pchar), "pmask_l": jnp.asarray(pmask),
                 "pgo": jnp.asarray(pgo), "pge": jnp.asarray(pge)}
        want = _module_scan_xla(jnp.asarray(seedT), jnp.asarray(lut), jnp.asarray(sdo),
                                jnp.asarray(sde), fixed, st=st)
        np.testing.assert_array_equal(got[z].numpy(), np.asarray(want))


def _configs():
    al = get_alphabet("dna")
    return {
        "random": random_config(np.random.default_rng(5), al),
        "default_scaled": TemplateSwitchConfig.default(al).scaled_for_length_tiebreak(64),
    }


def _kinds(cfg, ref, qry, chunk, budget=None):
    """(spec, port KindModule, JaxKindModule) for every active kind."""
    out = []
    n_r, n_q = len(ref), len(qry)
    port_cfg = config_from_reference(cfg)
    for pk in (0, 1):
        anti_lo, anti_hi = (0, n_q) if pk == 0 else (0, n_r)
        for sk in (0, 1):
            for dk in (0, 1):
                spec = make_kind_spec(cfg, n_r, n_q, pk, sk, dk, sdel_budget=budget)
                if spec is None:
                    continue
                port_spec = port_tsm.make_kind_spec(
                    port_cfg, n_r, n_q, pk, sk, dk, sdel_budget=budget)
                for name, value in vars(spec).items():
                    np.testing.assert_array_equal(getattr(port_spec, name), value, err_msg=name)
                km = KindModule(port_spec, port_cfg, ref, qry, anti_lo, anti_hi, chunk=chunk)
                jkm = JaxKindModule(spec, cfg, ref, qry, anti_lo, anti_hi, chunk=chunk)
                assert km.active == jkm.active
                if km.active:
                    out.append((spec, km, jkm))
    return out


def _pair_and_entry(seed, n=16):
    rng = np.random.default_rng(seed)
    al = get_alphabet("dna")
    ref, qry = related_pair(rng, al, max_len=n)
    A = rng.integers(0, 30, size=(len(ref) + 1, len(qry) + 1)).astype(np.int32)
    A[rng.random(A.shape) < 0.5] = DEV_INF
    return ref, qry, A


@pytest.mark.parametrize("cfg_name", ["random", "default_scaled"])
def test_kind_tables_and_same_sequence_scan_match_jax(cfg_name):
    cfg = _configs()[cfg_name]
    ref, qry, _ = _pair_and_entry(3)
    kinds = _kinds(cfg, ref, qry, chunk=8, budget=16)
    assert kinds
    n_same = 0
    for spec, km, jkm in kinds:
        for name, arr in km.host_tables().items():
            want = np.asarray(jkm._fixed[name])
            assert arr.dtype == want.dtype, name
            np.testing.assert_array_equal(arr, want, err_msg=name)
        st = jkm._static
        assert (km.W, km.L, km.OFF, km.LL, km.s_lo, km.S, km.ldiff0, km.chunk) == (
            st.W, st.L, st.OFF, st.LL, st.s_lo, st.S, st.ldiff0, st.chunk)
        assert [tuple(vars(p).values()) for p in km.plans] == [
            tuple(vars(p).values()) for p in st.plans]
        if spec.same_seq:
            n_same += 1
            want = np.asarray(_same_module_jit(jkm._fixed, st=st))
            # the engine's scan stops at the last level the assembly reads
            np.testing.assert_array_equal(km.same_module("cpu").numpy(),
                                          want[: km.L_read + 1])
            # the diagonal mode's plain path, alone and as two sets of a pair axis
            t = km.tables("cpu")
            names = ("seed", "lut", "sdo", "sde", "pchar_l", "pmask_l", "io_l", "ie_l")
            kw = dict(fwd=km.dk == 0, allow_sdel=km.allow_sdel)
            np.testing.assert_array_equal(
                module_scan_diag(*(t[n] for n in names), **kw).numpy(), want)
            pair = module_scan_diag(*(torch.stack([t[n], t[n]]) for n in names), **kw)
            np.testing.assert_array_equal(pair.numpy(), np.stack([want, want]))
    assert n_same


def _jax_fold(jkm, spec, A_cells, bases):
    st = jkm._static
    A_mod = A_cells if spec.pk == 0 else A_cells.T
    B_pre = (_same_module_jit(jkm._fixed, st=st) if spec.same_seq
             else jnp.zeros((1, 1), jnp.int32))
    PAD = max(0, -jkm.s_lo)
    width = PAD + spec.n_anti + 1 + max(0, jkm.chunk - 1 + jkm.s_hi)
    Rk = _kind_all_chunks(jnp.asarray(np.ascontiguousarray(A_mod)),
                          jnp.full((spec.n_p + 1, width), DEV_INF, jnp.int32),
                          jkm._fixed, jnp.asarray(bases, jnp.int32), B_pre, st=st, PAD=PAD)
    R0 = jnp.full(A_cells.shape, DEV_INF, jnp.int32)
    R = _fold_kind_cells(R0, Rk, np.int32(spec.n_anti_real), PAD=PAD,
                         n_anti=spec.n_anti, transpose=spec.pk == 1)
    return np.asarray(Rk), np.asarray(R)


def _port_fold(km, spec, A_cells, bases):
    A_mod = torch.from_numpy(np.ascontiguousarray(A_cells if spec.pk == 0 else A_cells.T))
    PAD = max(0, -km.s_lo)
    width = PAD + spec.n_anti + 1 + max(0, km.chunk - 1 + km.s_hi)
    (Rk,) = kind_all_chunks([km], A_mod[None], np.asarray([bases]), PAD, width)
    if Rk is None:
        Rk = torch.full((spec.n_p + 1, width), DEV_INF, dtype=torch.int32)
    R = fold_kind_cells(torch.full(A_cells.shape, DEV_INF, dtype=torch.int32), Rk,
                        spec.n_anti_real, PAD=PAD, n_anti=spec.n_anti,
                        transpose=spec.pk == 1)
    return Rk.numpy(), R.numpy()


def _bases(spec, C, skip):
    n_e = spec.n_anti + 1
    bases = [min(e0, n_e - C) for e0 in range(0, n_e, C)]
    return [-1 if i in skip else b for i, b in enumerate(bases)]


@pytest.mark.parametrize("cfg_name,seed", [("random", 1), ("default_scaled", 2)])
def test_chunks_assembly_and_fold_match_jax(cfg_name, seed):
    cfg = _configs()[cfg_name]
    ref, qry, A_cells = _pair_and_entry(seed)
    kinds = _kinds(cfg, ref, qry, chunk=6, budget=16)
    assert any(not s.same_seq for s, _, _ in kinds)
    for spec, km, jkm in kinds:
        bases = _bases(spec, km.chunk, skip={1})
        want_Rk, want_R = _jax_fold(jkm, spec, A_cells, bases)
        got_Rk, got_R = _port_fold(km, spec, A_cells, bases)
        np.testing.assert_array_equal(got_Rk, want_Rk)
        np.testing.assert_array_equal(got_R, want_R)


def test_reentry_field_does_not_depend_on_chunk_size():
    cfg = _configs()["default_scaled"]
    ref, qry, A_cells = _pair_and_entry(4, n=14)
    fields = []
    for chunk in (3, 5, 64):
        R = np.full(A_cells.shape, DEV_INF, np.int32)
        for spec, km, _ in _kinds(cfg, ref, qry, chunk=chunk, budget=8):
            _, Rk = _port_fold(km, spec, A_cells, _bases(spec, km.chunk, skip=set()))
            R = np.minimum(R, Rk)
        fields.append(R)
    assert (fields[0] < 2**29).any()
    np.testing.assert_array_equal(fields[0], fields[1])
    np.testing.assert_array_equal(fields[0], fields[2])


def test_plain_module_scan_rejects_negative_deletion_extension():
    args, _ = _scan_inputs(np.random.default_rng(0), 2, 2, 5, 2, 4)
    args = list(args)
    args[3] = args[3] - 3
    with pytest.raises(ValueError):
        module_scan_torch(*[torch.from_numpy(a) for a in args], fwd=True, allow_sdel=True)


def _assert_dead_stays_dead(B, skip_from):
    """After the first level whose exit minimum reaches skip_from, every
    later entry of that (row, column) is infinite (>= 2^29): the kernel's
    skipping mode may write DEV_INF there.  Returns how many entries that
    covers."""
    assert DEV_INF_THRESH <= skip_from <= DEV_INF
    left = torch.cummax((B >= skip_from).int(), dim=0).values.bool()
    assert bool((B[left] >= DEV_INF_THRESH).all())
    return int(left.sum())


@pytest.mark.parametrize("fwd", [True, False])
@pytest.mark.parametrize("allow_sdel", [True, False])
@pytest.mark.parametrize("seed,neg_sdo", [(0, False), (1, False), (2, True), (3, True)])
def test_dead_state_threshold_is_sound_on_random_inputs(fwd, allow_sdel, seed, neg_sdo):
    # The ranges of chip_smoke.py::module_inputs: LUT, io and ie down to -1,
    # a quarter of the rows dead at level 0, a quarter dying at a random level.
    NB, C, W, L, A = 12, 3, 37, 24, 6
    rng = np.random.default_rng(100 + seed)
    seedT = rng.integers(L, L + 40, size=(NB, C, W)).astype(np.int32)
    seedT[rng.random(seedT.shape) < 0.5] = DEV_INF
    seedT[1::4] = DEV_INF
    lut = rng.integers(-1, 7, size=(A, C, W)).astype(np.int32)
    lut[A - 1] = DEV_INF
    sdo = rng.integers(-2 if neg_sdo else 0, 6, size=(C, W)).astype(np.int32)
    sde = rng.integers(0, 3, size=(C, W)).astype(np.int32)
    pchar = rng.integers(0, A, size=(L, NB)).astype(np.int32)
    pmask = np.where(rng.random((L, NB)) < 0.02, DEV_INF, 0).astype(np.int32)
    cut = rng.integers(0, L + 1, size=NB)
    dying = (np.arange(L)[:, None] >= cut[None, :]) & (np.arange(NB)[None, :] % 4 == 3)
    pmask[dying] = DEV_INF
    pgo = rng.integers(-1, 6, size=A).astype(np.int32)
    pge = rng.integers(-1, 3, size=A).astype(np.int32)
    io = np.minimum(pgo[pchar].astype(np.int64) + pmask, DEV_INF).astype(np.int32)
    ie = np.minimum(pge[pchar].astype(np.int64) + pmask, DEV_INF).astype(np.int32)
    skip_from = dead_state_threshold(lut, sdo, pmask, io, ie, L, allow_sdel=allow_sdel)
    drop = 1 + (2 if neg_sdo and allow_sdel else 0)
    assert skip_from == DEV_INF_THRESH + (L + 1) * drop
    # per-char insertion costs give the same threshold as the per-level ones
    assert skip_from == dead_state_threshold(lut, sdo, pmask, pgo, pge, L, allow_sdel=allow_sdel)
    B = module_scan_torch(*[torch.from_numpy(a) for a in
                            (seedT, lut, sdo, sde, pchar, pmask, io, ie)],
                          fwd=fwd, allow_sdel=allow_sdel)
    assert _assert_dead_stays_dead(B, skip_from) > NB * C  # rows die at many levels
    # the plain version's dead states drift below DEV_INF: the band is needed
    assert bool(((B >= DEV_INF_THRESH) & (B < DEV_INF)).any())


@pytest.mark.parametrize("pk", [0, 1])
@pytest.mark.parametrize("dk", [0, 1])
def test_dead_state_threshold_is_sound_on_the_default_tables(pk, dk):
    """The K-scaled default config's real cross-kind tables for a 40 x 40
    pair: the tie-break bonus makes the lowest LUT entry -1, so the main
    path skips from 2^29 + L + 1."""
    cfg = config_from_reference(_configs()["default_scaled"])
    rng = np.random.default_rng(40 + 2 * pk + dk)
    ref = rng.integers(0, 4, size=40).astype(np.int8)
    qry = ref.copy()
    qry[rng.integers(0, 40, size=4)] = rng.integers(0, 4, size=4)
    spec = port_tsm.make_kind_spec(cfg, 40, 40, pk, 1 - pk, dk, sdel_budget=16)
    km = KindModule(spec, cfg, ref, qry, 0, 40, chunk=8)
    assert km.active and not km.same_seq
    assert km.skip_from == DEV_INF_THRESH + km.L + 1
    A_cells = rng.integers(0, 60, size=(41, 41)).astype(np.int32)
    A_cells[rng.random(A_cells.shape) < 0.6] = DEV_INF
    A_cells[::3] = DEV_INF  # pruned entry rows: dead at level 0
    t = km.tables("cpu")
    sl = slice(8, 16)
    seedT = sat_add(torch.from_numpy(A_cells)[:, sl][:, :, None], t["seed"][sl][None, :, :])
    B = module_scan_torch(seedT.contiguous(), t["lut"][:, sl].contiguous(),
                          t["sdo"][sl].contiguous(), t["sde"][sl].contiguous(),
                          t["pchar_l"], t["pmask_l"], t["io_l"], t["ie_l"],
                          fwd=dk == 0, allow_sdel=km.allow_sdel)
    assert bool((B < DEV_INF_THRESH).any())
    # every problem dies: the primary runs out at level n_p - p at the latest
    assert _assert_dead_stays_dead(B, km.skip_from) >= B[0].numel()


@pytest.mark.parametrize("fwd", [True, False])
def test_dead_state_threshold_is_nearly_tight(fwd):
    """A LUT of -1 lowers a lone seed by one a level.  A seed just under
    2^29 + L comes back below 2^29 at level L, so no threshold under that is
    sound; `dead_state_threshold` gives 2^29 + L + 1, and a seed there stays
    infinite."""
    NB, C, W, L, A = 2, 1, 9, 6, 2
    seedT = np.full((NB, C, W), DEV_INF, dtype=np.int32)
    seedT[0, 0, 0 if fwd else W - 1] = DEV_INF_THRESH + L - 1
    seedT[1, 0, 0 if fwd else W - 1] = DEV_INF_THRESH + L + 1
    lut = np.full((A, C, W), -1, dtype=np.int32)
    zeros_cw = np.zeros((C, W), dtype=np.int32)
    zeros_l = np.zeros((L, NB), dtype=np.int32)
    big_l = np.full((L, NB), DEV_INF, dtype=np.int32)
    skip_from = dead_state_threshold(lut, zeros_cw, zeros_l, big_l, big_l, L, allow_sdel=True)
    assert skip_from == DEV_INF_THRESH + L + 1
    B = module_scan_torch(*[torch.from_numpy(a) for a in
                            (seedT, lut, zeros_cw, zeros_cw, zeros_l, zeros_l, big_l, big_l)],
                          fwd=fwd, allow_sdel=True)
    assert B[:, 0, 0].tolist() == [DEV_INF_THRESH + L - 1 - l for l in range(L + 1)]
    assert int(B[0, 0, 0]) < skip_from and int(B[L, 0, 0]) == DEV_INF_THRESH - 1
    assert int(B[0, 1, 0]) == skip_from
    _assert_dead_stays_dead(B, skip_from)


@pytest.mark.parametrize("lowest,L,expect", [
    (0, 500, DEV_INF_THRESH),                      # nothing negative: skip from 2^29
    (-1, 500, DEV_INF_THRESH + 501),
    (-(2**20), 510, DEV_INF_THRESH + 511 * 2**20),   # the last L that fits
    (-(2**20), 511, 0),                            # (L + 1) * drop = 2^29: off
    (-(2**29), 1, 0),
])
def test_dead_state_threshold_is_off_when_it_overflows(lowest, L, expect):
    lut = np.array([[[3, lowest]]], dtype=np.int32)
    zero = np.zeros((1, 1), dtype=np.int32)
    assert dead_state_threshold(lut, zero, zero, zero, zero, L, allow_sdel=True) == expect


@pytest.mark.parametrize("got,want,equal", [
    ([0, 5, -3, 2**29 - 1], [0, 5, -3, 2**29 - 1], True),      # equal below 2^29
    ([7, DEV_INF], [7, DEV_INF - 4], True),                     # band-tolerant above
    ([7, 2**29], [7, DEV_INF], True),
    ([7, 2**29 - 1], [7, DEV_INF], False),                      # finite against infinite
    ([7, DEV_INF], [7, 2**29 - 1], False),                      # infinite against finite
    ([6, DEV_INF], [7, DEV_INF], False),                        # a finite value differs
])
def test_equal_mod_inf(got, want, equal):
    g = torch.tensor(got, dtype=torch.int32)
    w = torch.tensor(want, dtype=torch.int32)
    assert equal_mod_inf(g, w) is equal
    assert equal_mod_inf(g.view(-1, 1), w) is False  # another shape
