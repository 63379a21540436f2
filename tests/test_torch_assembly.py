"""The reentry assembly's wrapper (``ops/assembly.py``) against the JAX package.

On CPU tensors ``assembly_fold`` runs the plain version and folds in place;
here, with tolerance 0, on seeded numpy inputs:

  * one chunk of every kind (cross and same-sequence, both directions),
    folded into a slab that starts from seeded finite values and DEV_INF,
    equals ``jax_modules._assembly`` followed by the JAX package's slab
    minimum: the chunked route's diagonal fold at PAD + e_base + s_lo and
    the compact route's column by column fold (``separate_cols``) at
    PAD + e_c + s_lo; B holds DEV_INF, DEV_INF - 1 and values in
    [2^29, DEV_INF), and negative values;
  * under the default, the flanked default, random configurations and a
    configuration with negative ldiff, anti-gap and length costs;
  * a poison-padded bucket at two real query lengths, the pairs of one call
    (the pair axis) each against the JAX package;
  * ``kind_all_chunks`` and ``kind_sel_chunks`` through the wrapper against
    ``_kind_all_chunks`` and ``_kind_sel_chunks(gather=True)``.

The kernel itself runs on the card only (``tests/test_torch_kernels.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsalign_tpu.alphabet import get_alphabet
from tsalign_tpu.config import TemplateSwitchConfig
from tsalign_tpu.costs import INF, CostFunction, GapAffineCostTable
from tsalign_tpu.ops.jax_modules import (JaxKindModule, _assembly, _kind_all_chunks,
                                         _kind_sel_chunks, _same_module_jit)
from tsalign_tpu.ops.tsm_modules import make_kind_spec
from tsalign_tpu_torch.convert import config_from_reference
from tsalign_tpu_torch.ops import tsm_modules as port_tsm
from tsalign_tpu_torch.ops.assembly import assembly_fold
from tsalign_tpu_torch.ops.common import DEV_INF
from tsalign_tpu_torch.ops.modules import KindModule, kind_all_chunks, kind_sel_chunks

from torch_cases import negative_costs
from torch_util import one_torch_thread  # noqa: F401
from util import random_config

KINDS = [(pk, sk, dk) for pk in (0, 1) for sk in (0, 1) for dk in (0, 1)]


def _flanked_default():
    al = get_alphabet("dna-n")
    cfg = TemplateSwitchConfig.default(al)
    cfg.left_flank_length = cfg.right_flank_length = 2
    for side in ("Left", "Right"):
        table = GapAffineCostTable.base_agnostic(f"{side} Flank Edit Costs", al, 0, 1, 2, 1)
        setattr(cfg, f"{side.lower()}_flank_edit_costs", table)
    return cfg


def _negative_config():
    """A random configuration with the negative ldiff segments, anti-primary
    gaps and length costs of torch_cases.negative_costs (a value near
    DEV_INF then depends on the order of the saturating adds)."""
    cfg = random_config(np.random.default_rng(77), get_alphabet("dna"), flanks=False)
    return dataclasses.replace(cfg, base_cost={k: 1 for k in cfg.base_cost},
                               **negative_costs(CostFunction, INF))


def _config(name):
    if name == "default":
        return TemplateSwitchConfig.default(get_alphabet("dna-n"))
    if name == "flanked_default":
        return _flanked_default()
    if name == "negative":
        return _negative_config()
    return random_config(np.random.default_rng(int(name.split("_")[1])),
                         get_alphabet("dna"), flanks=False)


def _seeded_B(rng, shape):
    """Module exit minima with negative, DEV_INF, DEV_INF - 1 and
    [2^29, DEV_INF) entries."""
    B = rng.integers(-4, 40, size=shape).astype(np.int32)
    u = rng.random(shape)
    B[u < 0.2] = DEV_INF
    B[(u >= 0.2) & (u < 0.25)] = DEV_INF - 1
    big = (u >= 0.25) & (u < 0.3)
    B[big] = rng.integers(1 << 29, DEV_INF, size=int(big.sum()))
    return B


def _seeded_slab(rng, shape):
    slab = rng.integers(-10, 60, size=shape).astype(np.int32)
    slab[rng.random(shape) < 0.5] = DEV_INF
    return slab


def _modules(cfg, ref, qry, kind, chunk, n_q_real=None):
    """The JAX and the port's kind module of one kind (None where inactive)."""
    pk, sk, dk = kind
    n_r, n_q = len(ref), len(qry)
    kw = dict(sdel_budget=16)
    if n_q_real is not None:
        kw.update(n_ref_real=n_r, n_qry_real=n_q_real)
    spec = make_kind_spec(cfg, n_r, n_q, pk, sk, dk, **kw)
    if spec is None:
        return None
    port_cfg = config_from_reference(cfg)
    port_spec = port_tsm.make_kind_spec(port_cfg, n_r, n_q, pk, sk, dk, **kw)
    anti_hi = n_q if pk == 0 else n_r
    jkm = JaxKindModule(spec, cfg, ref, qry, 0, anti_hi, chunk=chunk)
    km = KindModule(port_spec, port_cfg, ref, qry, 0, anti_hi, chunk=chunk)
    if not jkm.active:
        assert not km.active
        return None
    assert (km.S, km.s_lo, km.L, km.chunk) == (jkm.S, jkm.s_lo, jkm._static.L, jkm.chunk)
    return jkm, km


def _jax_chunk_fold(jkm, B, A_chunk, slab, dest_base, dest=None):
    """``_assembly`` of one chunk and the JAX package's slab minimum."""
    st = jkm._static
    out = slab.copy()
    if dest is None:
        R = np.asarray(_assembly(jnp.asarray(B), jnp.asarray(A_chunk), jkm._fixed, st))
        cols = slice(dest_base, dest_base + R.shape[1])
        out[:, cols] = np.minimum(out[:, cols], R)
        return out
    U = np.asarray(_assembly(jnp.asarray(B), jnp.asarray(A_chunk), jkm._fixed,
                             st._replace(separate_cols=True)))
    for c, e in enumerate(dest):  # _kind_sel_chunks' fold_body, column by column
        cols = slice(dest_base + e, dest_base + e + jkm.S)
        out[:, cols] = np.minimum(out[:, cols], U[:, c])
    return out


def _chunk_inputs(rng, km, spec):
    C = km.chunk
    A_chunk = rng.integers(-3, 30, size=(spec.n_p + 1, C)).astype(np.int32)
    A_chunk[rng.random(A_chunk.shape) < 0.3] = DEV_INF
    shape = (km.L + 1, spec.n_p + 1) + (() if spec.same_seq else (C,))
    return _seeded_B(rng, shape), A_chunk


@pytest.mark.parametrize("name", ["default", "flanked_default", "random_40", "random_41",
                                  "negative"])
def test_assembly_fold_matches_jax_assembly_and_slab_minimum(name):
    cfg = _config(name)
    rng = np.random.default_rng(len(name))
    A = cfg.alphabet.size
    ref = rng.integers(0, min(A, 4), size=15).astype(np.int8)
    qry = rng.integers(0, min(A, 4), size=12).astype(np.int8)
    checked = set()
    for kind in KINDS:
        mods = _modules(cfg, ref, qry, kind, chunk=5)
        if mods is None:
            continue
        jkm, km = mods
        spec = km.spec
        B, A_chunk = _chunk_inputs(rng, km, spec)
        PAD = max(0, -km.s_lo)
        width = PAD + spec.n_anti + 1 + max(0, km.chunk - 1 + km.s_hi) + 2
        for compact in (False, True):
            slab0 = _seeded_slab(rng, (spec.n_p + 1, width))
            if compact:
                dest = rng.integers(0, spec.n_anti + 1, size=km.chunk)
                dest[-1] = dest[0]  # a sentinel slot: a duplicate column
                base = PAD + km.s_lo
            else:
                dest = None
                base = PAD + int(rng.integers(0, 3)) + km.s_lo
            want = _jax_chunk_fold(jkm, B, A_chunk, slab0, base, dest)
            got = torch.from_numpy(slab0.copy())
            assembly_fold([torch.from_numpy(B)], [torch.from_numpy(A_chunk)], [km],
                          [km.tables("cpu")], [got], base,
                          dest=None if dest is None else dest[None])
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{kind} {compact}")
            checked.add((spec.same_seq, km.dk, compact))
    # cross and same-sequence kinds, both directions, both destinations
    assert {(s, d, c) for s in (False, True) for d in (0, 1) for c in (False, True)} <= checked


@pytest.mark.parametrize("n_q_real", [(17, 6), (11, 20)])
def test_padded_bucket_pair_axis_matches_jax(n_q_real):
    """Two poison-padded pairs of one bucket with different real query
    lengths in one call: each pair's slab equals the JAX package's, with its
    own real anti length in the positive segments."""
    al = get_alphabet("dna")
    cfg_rng = np.random.default_rng(40)
    while True:  # a finite positive ldiff segment (the band ah cuts)
        cfg = random_config(cfg_rng, al, flanks=False)
        w = cfg.length_difference_costs.finite_window()
        if w is not None and w[1] >= 2:
            break
    rng = np.random.default_rng(sum(n_q_real))
    n_r, n_q = 14, 20
    ref = rng.integers(0, 4, size=n_r).astype(np.int8)
    positive = 0
    for kind in [k for k in KINDS if k[0] == 0]:
        pairs = []
        for nq in n_q_real:
            qry = np.full(n_q, al.size, dtype=np.int8)
            qry[:nq] = rng.integers(0, 4, size=nq)
            mods = _modules(cfg, ref, qry, kind, chunk=5, n_q_real=nq)
            if mods is not None:
                pairs.append(mods)
        if len(pairs) < 2:
            continue
        jkms, kms = zip(*pairs)
        assert all(km.padded for km in kms) and kms[0].ah_real != kms[1].ah_real
        spec = kms[0].spec
        PAD = max(0, -kms[0].s_lo)
        width = PAD + spec.n_anti + 1 + max(0, kms[0].chunk - 1 + kms[0].s_hi)
        base = PAD + kms[0].s_lo
        ins = [_chunk_inputs(rng, km, spec) for km in kms]
        slabs0 = [_seeded_slab(rng, (spec.n_p + 1, width)) for _ in kms]
        got = [torch.from_numpy(s.copy()) for s in slabs0]
        assembly_fold([torch.from_numpy(B) for B, _ in ins],
                      [torch.from_numpy(A) for _, A in ins], list(kms),
                      [km.tables("cpu") for km in kms], got, base)
        for z, jkm in enumerate(jkms):
            assert int(jkm._fixed["ah_real"]) == kms[z].ah_real
            want = _jax_chunk_fold(jkm, *ins[z], slabs0[z], base)
            np.testing.assert_array_equal(got[z].numpy(), want, err_msg=f"{kind} pair {z}")
        positive += sum(p.positive for p in kms[0].plans)
    assert positive


def test_assembly_fold_checks_its_inputs():
    cfg = _config("default")
    rng = np.random.default_rng(3)
    ref = rng.integers(0, 4, size=15).astype(np.int8)
    qry = rng.integers(0, 4, size=12).astype(np.int8)
    _, km = _modules(cfg, ref, qry, (0, 1, 0), chunk=5)
    B, A_chunk = _chunk_inputs(rng, km, km.spec)
    t = km.tables("cpu")
    PAD = max(0, -km.s_lo)
    slab = torch.full((km.spec.n_p + 1, PAD + km.spec.n_anti + km.S + 8), DEV_INF,
                      dtype=torch.int32)
    args = [torch.from_numpy(B)], [torch.from_numpy(A_chunk)], [km], [t]
    with pytest.raises(ValueError):  # runs off the slab
        assembly_fold(*args, [slab[:, :5]], PAD + km.s_lo)
    with pytest.raises(ValueError):  # a B of another shape
        assembly_fold([torch.from_numpy(B[:-1])], *args[1:], [slab], PAD + km.s_lo)
    with pytest.raises(ValueError):  # dest of another shape
        assembly_fold(*args, [slab], PAD + km.s_lo, dest=np.zeros((1, 2), np.int64))


def _entry_field(rng, spec):
    A = rng.integers(0, 30, size=(spec.n_p + 1, spec.n_anti + 1)).astype(np.int32)
    A[rng.random(A.shape) < 0.4] = DEV_INF
    return A


@pytest.mark.parametrize("name", ["random_42", "negative"])
def test_chunk_loops_match_jax(name):
    """``kind_all_chunks`` (every chunk, one skipped) and ``kind_sel_chunks``
    (a live-column bucket with sentinel slots) through the wrapper equal the
    JAX package's ``_kind_all_chunks`` and ``_kind_sel_chunks(gather=True)``."""
    cfg = _config(name)
    rng = np.random.default_rng(9)
    ref = rng.integers(0, 4, size=13).astype(np.int8)
    qry = rng.integers(0, 4, size=11).astype(np.int8)
    n_checked = 0
    for kind in KINDS:
        mods = _modules(cfg, ref, qry, kind, chunk=4)
        if mods is None:
            continue
        jkm, km = mods
        spec, st, C = km.spec, jkm._static, km.chunk
        A_mod = _entry_field(rng, spec)
        B_pre = (_same_module_jit(jkm._fixed, st=st) if spec.same_seq
                 else jnp.zeros((1, 1), jnp.int32))
        PAD = max(0, -km.s_lo)
        n_e = spec.n_anti + 1
        bases = [min(e0, n_e - C) for e0 in range(0, n_e, C)]
        if len(bases) > 1:
            bases[1] = -1  # a skipped chunk
        width = PAD + n_e + max(0, C - 1 + km.s_hi)
        want = np.asarray(_kind_all_chunks(
            jnp.asarray(A_mod), jnp.full((spec.n_p + 1, width), DEV_INF, jnp.int32),
            jkm._fixed, jnp.asarray(bases, jnp.int32), B_pre, st=st, PAD=PAD))
        A_t = torch.from_numpy(A_mod)
        (got,) = kind_all_chunks([km], A_t[None], np.asarray([bases]), PAD, width)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{kind} chunked")
        live = np.nonzero((A_mod < DEV_INF).any(axis=0))[0][: C + 1]
        Kb = C
        while Kb < live.size:
            Kb *= 2
        e_sel = np.zeros(Kb, np.int64)
        e_sel[: live.size] = live
        OUTW = PAD + n_e + max(0, km.s_hi)
        want = np.asarray(_kind_sel_chunks(
            jnp.asarray(A_mod), jnp.asarray(e_sel.astype(np.int32)), jkm._fixed, B_pre,
            st=st._replace(separate_cols=True), PAD=PAD, OUTW=OUTW, gather=True))
        got = kind_sel_chunks([km], A_t[None], e_sel[None], PAD, OUTW)[0]
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{kind} compact")
        n_checked += 1
    assert n_checked >= 4
