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
    ``_kind_all_chunks`` and ``_kind_sel_chunks(gather=True)``, also where
    the module scan stops at L_read, below the pair's L;
  * B's levels above ``KindModule.L_read`` change neither the JAX package's
    assembly nor the port's, and its level L_read changes both, under the
    default, the flanked default, binding-window, random and negative
    configurations and on a poison-padded pair;
  * the engine (``TorchAligner``, the facade's record) against the JAX
    engine on pairs where the cap binds;
  * ``torch_cases.assembly_bytes``, the byte count of the kernel's bound,
    against a count of the entries the plain version's shear reads.

The kernel itself runs on the card only (``tests/test_torch_kernels.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tsalign_tpu_torch
from tsalign_tpu.aligner import Aligner as JaxFacade
from tsalign_tpu.alphabet import get_alphabet
from tsalign_tpu.config import TemplateSwitchConfig
from tsalign_tpu.costs import INF, CostFunction, GapAffineCostTable
from tsalign_tpu.jax_engine import JaxAligner
from tsalign_tpu.ops.jax_modules import (JaxKindModule, _assembly, _kind_all_chunks,
                                         _kind_sel_chunks, _same_module_jit)
from tsalign_tpu.ops.tsm_modules import make_kind_spec
from tsalign_tpu_torch.convert import config_from_reference
from tsalign_tpu_torch.ops import tsm_modules as port_tsm
from tsalign_tpu_torch.ops.assembly import assembly_fold
from tsalign_tpu_torch.ops.common import DEV_INF
from tsalign_tpu_torch.engine import TorchAligner
from tsalign_tpu_torch.ops.modules import (KindModule, assembly_torch, kind_all_chunks,
                                           kind_sel_chunks)

from torch_cases import assembly_bytes, negative_costs
from torch_util import one_torch_thread  # noqa: F401
from util import binding_window_config, random_config, related_pair_scaled

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
    if name.startswith("binding"):
        return binding_window_config(np.random.default_rng(int(name.split("_")[1])),
                                     get_alphabet("dna"), 0, 0)
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
            assembly_fold([torch.from_numpy(B[: km.L_read + 1])], [torch.from_numpy(A_chunk)], [km],
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
        assembly_fold([torch.from_numpy(B[: km.L_read + 1]) for (B, _), km in zip(ins, kms)],
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
    B = B[: km.L_read + 1]
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
    assert len(_check_chunk_loops(cfg, ref, qry, 4, rng)) >= 4


@pytest.mark.parametrize("seed", [2, 59])
def test_chunk_loops_match_jax_where_levels_are_capped(seed):
    """The chunk loops of a 48 x 44 pair under a binding-window
    configuration, where the module scan stops at L_read < L: equal to the
    JAX package's loops, which scan all L levels."""
    cfg = _config(f"binding_{seed}")
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, size=48).astype(np.int8)
    qry = rng.integers(0, 4, size=44).astype(np.int8)
    kms = _check_chunk_loops(cfg, ref, qry, 8, rng)
    assert len(kms) >= 4 and all(km.L_read < km.L for km in kms)


def _check_chunk_loops(cfg, ref, qry, chunk, rng):
    """``kind_all_chunks`` (every chunk, one skipped) and ``kind_sel_chunks``
    (a live-column bucket with sentinel slots) of every active kind against
    the JAX package's; returns the kinds checked."""
    checked = []
    for kind in KINDS:
        mods = _modules(cfg, ref, qry, kind, chunk=chunk)
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
        checked.append(km)
    return checked


@pytest.mark.parametrize("name,n_r,n_q,n_q_real", [
    ("default", 230, 210, None), ("flanked_default", 230, 210, None),
    ("binding_2", 52, 47, None), ("binding_59", 48, 44, None), ("random_40", 40, 34, None),
    ("negative", 50, 45, None), ("binding_70", 52, 50, 41)])
def test_levels_above_L_read_never_change_the_assembly(name, n_r, n_q, n_q_real):
    """B's levels above L_read, replaced by other seeded values, change
    neither ``_assembly`` nor ``assembly_torch``; every entry of level
    L_read lowered changes both, and ``assembly_fold`` on B's first
    L_read + 1 levels equals the JAX package's fold on all of B either way
    (the last case a poison-padded pair)."""
    cfg = _config(name)
    rng = np.random.default_rng(n_r + n_q)
    A = cfg.alphabet.size
    ref = rng.integers(0, min(A, 4), size=n_r).astype(np.int8)
    qry = rng.integers(0, min(A, 4), size=n_q).astype(np.int8)
    if n_q_real is not None:
        qry[n_q_real:] = A
    capped = changed = 0
    for kind in KINDS if n_q_real is None else [k for k in KINDS if k[0] == 0]:
        mods = _modules(cfg, ref, qry, kind, chunk=4, n_q_real=n_q_real)
        if mods is None:
            continue
        jkm, km = mods
        spec, Lr = km.spec, km.L_read
        t = km.tables("cpu")
        B, A_chunk = _chunk_inputs(rng, km, spec)
        capped += Lr < km.L
        noise = B.copy()
        noise[Lr + 1 :] = _seeded_B(rng, noise[Lr + 1 :].shape)
        low = B.copy()
        low[Lr] = -20
        PAD = max(0, -km.s_lo)
        width = PAD + spec.n_anti + 1 + max(0, km.chunk - 1 + km.s_hi)
        base = PAD + km.s_lo
        slab0 = _seeded_slab(rng, (spec.n_p + 1, width))
        want = _jax_chunk_fold(jkm, B, A_chunk, slab0, base)
        np.testing.assert_array_equal(_jax_chunk_fold(jkm, noise, A_chunk, slab0, base), want)
        R = assembly_torch(torch.from_numpy(B), torch.from_numpy(A_chunk), km, t)
        assert torch.equal(
            assembly_torch(torch.from_numpy(noise), torch.from_numpy(A_chunk), km, t), R)
        want_low = _jax_chunk_fold(jkm, low, A_chunk, slab0, base)
        R_low = assembly_torch(torch.from_numpy(low), torch.from_numpy(A_chunk), km, t)
        assert torch.equal(R_low, R) == np.array_equal(want_low, want)
        changed += not np.array_equal(want_low, want)
        for Bx, wx in ((B, want), (low, want_low)):
            got = torch.from_numpy(slab0.copy())
            assembly_fold([torch.from_numpy(Bx[: Lr + 1])], [torch.from_numpy(A_chunk)], [km],
                          [t], [got], base)
            np.testing.assert_array_equal(got.numpy(), wx, err_msg=f"{kind}")
    assert capped and changed


@pytest.mark.parametrize("seed", [59, 70])
def test_engine_matches_jax_where_levels_are_capped(seed):
    """``TorchAligner(device="cpu")`` and the facade's record against the
    JAX engine's on a 48 bp pair under a binding-window configuration, whose
    kinds' module scans stop at L_read < L."""
    rng = np.random.default_rng(seed)
    al = get_alphabet("dna")
    cfg = binding_window_config(rng, al, 0, 0)
    ref, qry = related_pair_scaled(rng, al, 48, ts_len=8)
    port_cfg = config_from_reference(cfg)
    kms = [m[1] for m in (_modules(cfg, ref, qry, kind, chunk=32) for kind in KINDS) if m]
    assert kms and all(km.L_read < km.L for km in kms)
    want = JaxAligner(cfg, ref, qry, chunk=32).align()
    got = TorchAligner(port_cfg, ref, qry, device="cpu", chunk=32).align()
    assert (got.cost, got.rounds) == (want.cost, want.rounds)
    r, q = al.decode(ref), al.decode(qry)
    want = JaxFacade(costs=cfg, engine="jax").align(r, q)
    got = tsalign_tpu_torch.Aligner(costs=port_cfg, device="cpu").align(r, q)
    assert got.stats()["cost"] == want.stats()["cost"]

    def record(res):
        return [line for line in res.to_toml().splitlines()
                if not line.startswith(("duration_seconds", "runtime"))]

    assert record(got) == record(want)


@pytest.mark.parametrize("name,n_r,n_q,n_q_real", [
    ("default", 230, 210, None), ("binding_2", 52, 47, None), ("random_41", 30, 26, None),
    ("binding_70", 52, 50, 41)])
def test_assembly_bytes_count_the_entries_the_shear_reads(name, n_r, n_q, n_q_real):
    """The bytes of the assembly kernel's bound (``torch_cases.assembly_bytes``)
    against a count of the B (and, same-sequence, entry-chunk) entries whose
    (row, level) pair the plain version's shear reads; B's other entries,
    replaced by other values, do not change ``assembly_torch``."""
    cfg = _config(name)
    port_cfg = config_from_reference(cfg)
    rng = np.random.default_rng(n_r)
    A = cfg.alphabet.size
    ref = rng.integers(0, min(A, 4), size=n_r).astype(np.int8)
    qry = rng.integers(0, min(A, 4), size=n_q).astype(np.int8)
    kw = dict(sdel_budget=16)
    if n_q_real is not None:
        qry[n_q_real:] = A
        kw.update(n_ref_real=n_r, n_qry_real=n_q_real)
    n_kinds = 0
    for pk, sk, dk in KINDS:
        spec = port_tsm.make_kind_spec(port_cfg, n_r, n_q, pk, sk, dk, **kw)
        if spec is None:
            continue
        km = KindModule(spec, port_cfg, ref, qry, 0, n_q if pk == 0 else n_r, chunk=6)
        if not km.active:
            continue
        n_rows, C, Lr = spec.n_p + 1, km.chunk, km.L_read
        read = np.zeros((km.L + 1, n_rows), bool)  # (level, source row) of B
        rows = np.zeros(n_rows, bool)  # entry rows p2 - l read
        for p2 in range(n_rows):
            for lv in range(Lr + 1):
                if p2 - lv >= 0:
                    read[lv, p2 - lv] = True
                    rows[p2 - lv] = True
        entries = (int(read.sum()) + int(rows.sum()) * C if km.same_seq
                   else int(read.sum()) * C)
        span = C + km.S - 1
        assert assembly_bytes(km, n_rows, C, span) == 4 * (
            entries + 2 * n_rows * span + Lr + 1 + km.S), (pk, sk, dk)
        B, A_chunk = _chunk_inputs(rng, km, spec)
        other = B.copy()
        other[~read] = _seeded_B(rng, other.shape)[~read]
        t = km.tables("cpu")
        assert torch.equal(
            assembly_torch(torch.from_numpy(other), torch.from_numpy(A_chunk), km, t),
            assembly_torch(torch.from_numpy(B), torch.from_numpy(A_chunk), km, t))
        n_kinds += 1
    assert n_kinds >= 4
