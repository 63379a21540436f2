"""The port's chained mode against the JAX package's (tolerance 0).

``tsalign_tpu_torch/chain/`` against ``tsalign_tpu/chain/`` on the CPU, on
seeded numpy inputs:

  * part by part: ``Anchors.build`` (native and numpy), ``compute_chain``
    (native and numpy DP) and ``exact_match_runs``, ``_window_radius`` and
    ``_segment_cuts`` over random, narrow, flanked and default configs,
    ``compute_plan`` with the cache's round trip and its errors;
  * the focus-range engines on poison-padded buckets, with root seeds and
    targets away from (0, 0): ``BatchedTSAligner(ranges=...)`` in batches of
    1, 3 and 32 windows of mixed lengths and offsets (costs, rounds,
    tracebacks; remaining bound on and off), and
    ``TorchAligner(range_=..., prune_range=False, keep_fields=...)`` against
    ``JaxAligner`` with the same keywords;
  * ``chain_align(..., device="cpu")`` against ``chain_align(...,
    engine="jax")``: cost, segments, anchors, rejoined cuts, TS length and
    the alignment's entries, on the 160 bp pair of
    tests/test_chain.py, the 1.5 kb construction of tests/test_chain_scale.py,
    a flanked config, one template switch at most (the per-segment path),
    no verification pass, and the three-segment and wide-footprint
    structures of tests/test_chain.py whose cuts the verification must
    rejoin; the port's ``engine="numpy"`` against the JAX package's;
  * ``progress=True`` prints a rejoin (the JAX package raises there);
  * the smoke's chained fixture and construction.

The JAX engine compiles per shape, so the cases share the 128 and 256
buckets of the 1.5 kb run.
"""

import dataclasses
import importlib.util
import json
import os
import signal
import sys

import numpy as np
import pytest

from tsalign_tpu.alphabet import get_alphabet
from tsalign_tpu.chain import anchors as jax_anchors
from tsalign_tpu.chain import chain as jax_chainmod
from tsalign_tpu.chain import driver as jax_driver
from tsalign_tpu.chain import plan as jax_plan
from tsalign_tpu.config import TemplateSwitchConfig
from tsalign_tpu.costs import INF, CostFunction
from tsalign_tpu.geometry import AlignmentRange
from tsalign_tpu.jax_engine import JaxAligner
from tsalign_tpu.parallel import batch_ts as jax_batch
from tsalign_tpu_torch.chain import anchors, driver, native, plan
from tsalign_tpu_torch.chain import chain as chainmod
from tsalign_tpu_torch.convert import config_from_reference, range_from_reference
from tsalign_tpu_torch.engine import TorchAligner
from tsalign_tpu_torch.parallel import batch_ts as port_batch

from test_chain import _NARROW_CONFIG
from torch_util import one_torch_thread  # noqa: F401
from util import binding_window_config, random_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import CHAIN_CFG, CHAIN_FIXTURE, chain_construction  # noqa: E402



def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_scale = _script("validate_chain_scale")
# the 160 bp pair and random config of
# tests/test_chain.py::test_chain_align_jax_engine_matches_full
_random_160 = _script("make_torch_port_fixture").random_chain_pair


def _narrow():
    return TemplateSwitchConfig.parse_plain(_NARROW_CONFIG, get_alphabet("dna-n"))


def _widened(base_cost):
    """The narrow config with +-90 jump windows and TS lengths 5..89, as in
    tests/test_chain.py's adversarial structures."""
    def window(lo, hi, cost=0):
        return CostFunction([(-(2**62), INF), (lo, cost), (hi + 1, INF)])

    base = _narrow()
    return dataclasses.replace(
        base,
        base_cost={k: base_cost for k in base.base_cost},
        rq_qr_offset_costs=window(-90, 90),
        rr_qq_offset_costs=window(-90, 90),
        length_costs=CostFunction([(0, INF), (5, 0), (90, INF)]),
        length_difference_costs=window(-4, 4),
    )


def _three_segment():
    """tests/test_chain.py::test_verification_catches_three_segment_structures."""
    comp = get_alphabet("dna-n").complement_array()
    rng = np.random.default_rng(42)
    ref = rng.integers(0, 4, 200).astype(np.int8)
    s = rng.integers(0, 4, 24).astype(np.int8)
    ref[66:114] = np.concatenate([s, comp[s][::-1]]).astype(np.int8)
    qry = ref.copy()
    qry[56:124] = comp[ref[56:124]][::-1]
    return _widened(5), ref, qry, dict(k=6, target_segment=48)


def _wide_footprint():
    """tests/test_chain.py::test_footprint_certificate_catches_wide_structures."""
    comp = get_alphabet("dna-n").complement_array()
    rng = np.random.default_rng(7)
    ref = rng.integers(0, 4, 160).astype(np.int8)
    s = rng.integers(0, 4, 30).astype(np.int8)
    ref[50:110] = np.concatenate([s, comp[s][::-1]]).astype(np.int8)
    qry = ref.copy()
    qry[40:120] = comp[ref[40:120]][::-1]
    return _widened(25), ref, qry, dict(k=4, target_segment=48)


def _flanked():
    """A 160 bp pair under a binding-window config with two left and one
    right flank layer (tests/test_chain.py's flanked case, shortened)."""
    al = get_alphabet("dna")
    comp = al.complement_array()
    rng = np.random.default_rng(42)
    cfg = binding_window_config(rng, al, 2, 1)
    ref = rng.integers(0, 4, size=160).astype(np.int8)
    qry = ref.copy()
    qry[70:78] = [comp[c] for c in qry[70:78]][::-1]
    qry[30] = (qry[30] + 1) % 4
    qry[130] = (qry[130] + 1) % 4
    return cfg, ref, qry, dict(target_segment=64)


@pytest.fixture
def time_limit(request):
    """limit(seconds): fail the test once it has run that long (SIGALRM)."""
    def limit(seconds):
        def expire(signum, frame):
            raise TimeoutError(f"{request.node.name} ran over its limit of {seconds} s")

        old = signal.signal(signal.SIGALRM, expire)
        signal.alarm(seconds)
        request.addfinalizer(lambda: (signal.alarm(0), signal.signal(signal.SIGALRM, old)))
    return limit


def _key(res):
    return (res.cost, res.segments, res.anchors, res.cuts_rejoined, res.ts_total_length,
            str(res.alignment.entries))


# ---- parts ----------------------------------------------------------------


@pytest.mark.parametrize("use_native", [True, False])
def test_anchors_match(use_native):
    rng = np.random.default_rng(7000)
    for _ in range(12):
        n1, n2 = int(rng.integers(0, 150)), int(rng.integers(0, 150))
        k = int(rng.integers(2, 12))
        r = rng.integers(0, 5, size=n1).astype(np.int8)  # N poisons a window
        q = rng.integers(0, 5, size=n2).astype(np.int8)
        want = jax_anchors.Anchors.build(r, q, k, use_native=False)
        got = anchors.Anchors.build(r, q, k, use_native=use_native)
        np.testing.assert_array_equal(got.ref_pos, want.ref_pos)
        np.testing.assert_array_equal(got.qry_pos, want.qry_pos)
        assert got.native == use_native  # g++ builds csrc/anchors.cpp here
    for n in (0, 5, 40, 3000):
        assert anchors.choose_k(n) == jax_anchors.choose_k(n)


def test_native_library_lands_in_the_build_directory():
    lib = native._build_and_load()
    assert lib is not None
    path = os.path.realpath(lib._name)
    assert os.path.dirname(path) == os.path.join(ROOT, "tsalign_tpu_torch", "_build")
    assert os.path.basename(path).startswith("libtsanchors-")


@pytest.mark.parametrize("dp", ["native", "numpy"])
def test_chain_and_runs_match(dp, monkeypatch):
    if dp == "numpy":
        monkeypatch.setattr(native, "chain_native", lambda *a, **k: None)
    rng = np.random.default_rng(7100)
    comp = get_alphabet("dna").complement_array()
    for trial in range(6):
        n = int(rng.integers(150, 500))
        r = rng.integers(0, 4, size=n).astype(np.int8)
        q = r.copy()
        for _ in range(int(rng.integers(1, 6))):
            p = int(rng.integers(0, n))
            q[p] = (q[p] + 1) % 4
        a = int(rng.integers(10, n - 30))
        q[a : a + 12] = comp[q[a : a + 12]][::-1]
        q = np.delete(q, int(rng.integers(0, n))) if trial % 2 else q
        k = anchors.choose_k(len(r) + len(q))
        got_a = anchors.Anchors.build(r, q, k)
        want_a = jax_anchors.Anchors.build(r, q, k)
        kw = dict(match_score=int(rng.integers(1, 9)), drift_unit=int(rng.integers(1, 3)),
                  window=int(rng.integers(8, 80)))
        got = chainmod.compute_chain(got_a, **kw)
        want = jax_chainmod.compute_chain(want_a, **kw)
        np.testing.assert_array_equal(got.ref_pos, want.ref_pos)
        np.testing.assert_array_equal(got.qry_pos, want.qry_pos)
        assert chainmod.exact_match_runs(got) == jax_chainmod.exact_match_runs(want)


def _configs():
    rng = np.random.default_rng(7200)
    al = get_alphabet("dna")
    out = [("narrow", _narrow()), ("widened", _widened(5)),
           ("default", TemplateSwitchConfig.default(get_alphabet("dna-n"))),
           ("flanked", binding_window_config(rng, al, 2, 1))]
    out += [(f"random_{i}", random_config(rng, al, flanks=i % 2 == 1)) for i in range(4)]
    return out


def test_window_radius_and_segment_cuts_match():
    rng = np.random.default_rng(7300)
    for name, cfg in _configs():
        radius = driver._window_radius(config_from_reference(cfg))
        assert radius == jax_driver._window_radius(cfg), name
        for _ in range(5):
            n = int(rng.integers(200, 4000))
            pos, runs = 0, []
            while pos < n - 40:
                length = int(rng.integers(4, 400))
                runs.append((pos, pos + int(rng.integers(0, 3)), length))
                pos += length + int(rng.integers(1, 30))
            min_run, target = int(rng.integers(8, 40)), int(rng.integers(48, 1024))
            start = (int(rng.integers(0, 20)), int(rng.integers(0, 20)))
            args = (runs, n, n + 2, min_run, target)
            assert driver._segment_cuts(*args, start=start) == jax_driver._segment_cuts(
                *args, start=start), name


def test_plan_matches_and_round_trips(tmp_path):
    for name, cfg in _configs():
        port_cfg = config_from_reference(cfg)
        assert plan.config_digest(port_cfg) == jax_plan.config_digest(cfg)
        for k, max_n in ((6, 256), (13, 1 << 18)):
            got = plan.compute_plan(port_cfg, k, max_n)
            assert dataclasses.asdict(got) == dataclasses.asdict(
                jax_plan.compute_plan(cfg, k, max_n)), name
    for n_r, n_q in ((1, 1), (100, 300), (230000, 229000)):
        assert plan.infer_max_n(n_r, n_q) == jax_plan.infer_max_n(n_r, n_q)
    cfg = config_from_reference(_narrow())
    cache = str(tmp_path / "cache")
    with pytest.raises(plan.PlanCacheError, match="no cache file found"):
        plan.load_or_create_plan(cfg, cache, 6, 256, force_no_preprocessing=True)
    with pytest.raises(plan.PlanCacheError, match="no cache directory"):
        plan.load_or_create_plan(cfg, None, 6, 256, force_no_preprocessing=True)
    stored = plan.load_or_create_plan(cfg, cache, 6, 256)
    path = plan.plan_cache_path(cache, plan.config_digest(cfg), 6, 256)
    assert path == jax_plan.plan_cache_path(cache, plan.config_digest(cfg), 6, 256)
    # the JAX package reads the port's cache file and the port its own
    assert jax_plan.load_or_create_plan(_narrow(), cache, 6, 256,
                                        force_no_preprocessing=True) == jax_plan.ChainPlan(
        **dataclasses.asdict(stored))
    assert plan.load_or_create_plan(cfg, cache, 6, 256, force_no_preprocessing=True) == stored
    with open(path, "w") as f:
        f.write(dataclasses.replace(stored, k=7).to_json())
    with pytest.raises(plan.PlanCacheError, match="does not match"):
        plan.load_or_create_plan(cfg, cache, 6, 256)


# ---- the focus-range engines ----------------------------------------------


def _windows(n_windows, seed, max_len):
    """Chain-style windows on the 1.5 kb construction: a focus window of
    12-96 characters inside up to 40 characters of context on either side
    (fewer at the ends), so that the root seed and the target lie away from
    the corners; one window of each batch is the longest, the rest of mixed
    lengths, all poison-padded into the longest one's bucket."""
    ref, qry, _, _ = chain_construction(1500, 3000)
    rng = np.random.default_rng(seed)
    pairs, ranges = [], []
    for i in range(n_windows):
        while True:
            r0 = int(rng.integers(0, 1400))
            q0 = r0 + int(rng.integers(-3, 4))
            span = int(rng.integers(12, 97))
            r1, q1 = r0 + span, q0 + span + int(rng.integers(-2, 3))
            cr0, cq0 = max(0, r0 - 40), max(0, q0 - 40)
            cr1, cq1 = min(1500, r1 + 40), min(1500, q1 + 40)
            if q0 >= 0 and q1 <= 1500 and max(cr1 - cr0, cq1 - cq0) <= max_len and (
                    i > 0 or max(cr1 - cr0, cq1 - cq0) > max_len // 2):
                break
        pairs.append((ref[cr0:cr1], qry[cq0:cq1]))
        ranges.append(AlignmentRange(r0 - cr0, q0 - cq0, r1 - cr0, q1 - cq0))
    return pairs, ranges


@pytest.mark.parametrize("use_lower_bounds", [True, False])
@pytest.mark.parametrize("n_windows", [1, 3, 32])
def test_batched_ranges_match_jax(n_windows, use_lower_bounds):
    cfg = _narrow()
    port_cfg = config_from_reference(cfg)
    bucket = 256 if n_windows == 1 else 128
    pairs, ranges = _windows(n_windows, 7400 + n_windows, bucket)
    assert any(rg.reference_offset > 0 and rg.query_offset > 0 for rg in ranges)
    kw = dict(use_lower_bounds=use_lower_bounds)
    # cost-only, as the chain's verification probes run it
    want = jax_batch.BatchedTSAligner(cfg, pairs, ranges=ranges, **kw)._align_host()
    got_bt = port_batch.BatchedTSAligner(port_cfg, pairs, ranges=[
        range_from_reference(rg) for rg in ranges], device="cpu", **kw)
    assert got_bt.nr == got_bt.nq == bucket
    got = got_bt.align()
    assert [(g.cost, g.rounds) for g in got] == [(w.cost, w.rounds) for w in want]
    assert all(w.cost < INF for w in want)
    if n_windows == 32:
        return  # the traceback of 32 windows adds nothing but time
    # with tracebacks under the K-scaled tie-break, as the chain's segments
    K = 2 * got_bt.nr
    want_bt = jax_batch.BatchedTSAligner(cfg.scaled_for_length_tiebreak(K), pairs,
                                         ranges=ranges, **kw)
    want_bt.align = want_bt._align_host
    got_bt = port_batch.BatchedTSAligner(port_cfg.scaled_for_length_tiebreak(K), pairs,
                                         ranges=[range_from_reference(rg) for rg in ranges],
                                         device="cpu", **kw)
    traced = got_bt.align_with_traceback()
    for (cw, aw), (cg, ag) in zip(want_bt.align_with_traceback(), traced):
        assert cg == cw and str(ag) == str(aw)
    assert [r.rounds for r in got_bt.last_results] == [r.rounds for r in want_bt.last_results]
    assert got_bt.sdel_budget == want_bt.sdel_budget


@pytest.mark.parametrize("keep_fields", [False, "device", True])
@pytest.mark.parametrize("use_lower_bounds", [True, False])
def test_single_focus_range_matches_jax(use_lower_bounds, keep_fields):
    """The per-segment path's engine: a window padded to its bucket with
    the poison character, NoPrune over the bucket, a focus range inside."""
    cfg = _narrow()
    pairs, ranges = _windows(1, 7500, 128)
    (sub_r, sub_q), rg = pairs[0], ranges[0]
    P = cfg.alphabet.size
    sub_r = np.concatenate([sub_r, np.full(128 - len(sub_r), P, np.int8)])
    sub_q = np.concatenate([sub_q, np.full(128 - len(sub_q), P, np.int8)])
    scaled = keep_fields is not False
    jcfg = cfg.scaled_for_length_tiebreak(256) if scaled else cfg
    kw = dict(range_=rg, prune_range=False, keep_fields=keep_fields,
              use_lower_bounds=use_lower_bounds)
    want_eng = JaxAligner(jcfg, sub_r, sub_q, **kw)
    got_eng = TorchAligner(config_from_reference(jcfg), sub_r, sub_q, device="cpu",
                           **dict(kw, range_=range_from_reference(rg)))
    if not scaled:
        want, got = want_eng.align(), got_eng.align()
        assert (got.cost, got.rounds) == (want.cost, want.rounds) and want.cost < INF
        assert got.primary_fields == got.reentry_fields == []
        return
    (cw, aw), (cg, ag) = want_eng.align_with_traceback(), got_eng.align_with_traceback()
    assert cg == cw < INF and str(ag) == str(aw)
    assert got_eng.last_rounds == want_eng.last_rounds
    if keep_fields is True:
        res = TorchAligner(config_from_reference(jcfg), sub_r, sub_q, device="cpu",
                           **dict(kw, range_=range_from_reference(rg))).align()
        assert all(isinstance(m, np.ndarray) for m in res.primary_fields + res.reentry_fields)


# ---- chain_align ----------------------------------------------------------


def _scale_1500():
    ref, qry, expected, _ = chain_construction(1500, 3000)
    return _narrow(), ref, qry, dict(target_segment=512)


def _random_case():
    cfg, ref, qry = _random_160()
    return cfg, ref, qry, dict(target_segment=48)


CASES = {
    "random_160": _random_case,
    "scale_1500": _scale_1500,
    "flanked": _flanked,
    "max_ts_1": lambda: _random_case()[:3] + (dict(target_segment=48,
                                                   max_template_switches=1),),
    "no_verify": lambda: _random_case()[:3] + (dict(target_segment=48, verify=False),),
    # the three-segment structure's +-90 windows make every probe a
    # 256-bucket scan of up to 89 levels: about 310 s for the JAX engine and
    # 680 s for the port on one CPU thread, so it runs with the slow pins
    "three_segment": pytest.param(_three_segment, marks=pytest.mark.slow),
    "wide_footprint": _wide_footprint,
}
LIMITS = {"scale_1500": 300, "three_segment": 1500, "wide_footprint": 240}


@pytest.mark.parametrize("make", CASES.values(), ids=list(CASES))
def test_chain_align_matches_jax(make, time_limit, request):
    case = request.node.callspec.id
    time_limit(LIMITS.get(case, 120))
    cfg, ref, qry, kw = make()
    want = jax_driver.chain_align(cfg, ref, qry, engine="jax", **kw)
    got = driver.chain_align(config_from_reference(cfg), ref, qry, device="cpu", **kw)
    assert _key(got) == _key(want)
    assert got.numpy_fallbacks == 0 and got.anchors_native
    if case in ("three_segment", "wide_footprint"):
        assert got.cuts_rejoined >= 2
    if case == "scale_1500":
        assert got.cost == chain_construction(1500, 3000)[2]


@pytest.mark.parametrize("case", ["random_160", "wide_footprint"])
def test_chain_align_numpy_engine_matches_jax(case):
    cfg, ref, qry, kw = (_random_case if case == "random_160" else _wide_footprint)()
    want = jax_driver.chain_align(cfg, ref, qry, engine="numpy", **kw)
    got = driver.chain_align(config_from_reference(cfg), ref, qry, engine="numpy",
                             device="cpu", **kw)
    assert _key(got) == _key(want) and got.numpy_fallbacks == 0


def test_progress_prints_a_rejoin(capsys):
    cfg, ref, qry, kw = _wide_footprint()
    res = driver.chain_align(config_from_reference(cfg), ref, qry, engine="numpy",
                             device="cpu", progress=True, **kw)
    out = capsys.readouterr().out
    assert res.cuts_rejoined >= 2
    assert "suboptimal (cost " in out and "rejoining" in out
    with pytest.raises(ValueError, match="engine must be"):
        driver.chain_align(config_from_reference(cfg), ref, qry, engine="auto", device="cpu")


# ---- the smoke's inputs ---------------------------------------------------


def test_chain_fixture_config_is_the_scale_scripts():
    with open(CHAIN_CFG) as f:
        text = f.read()
    assert text == _scale.CONFIG
    assert TemplateSwitchConfig.parse_plain(text, get_alphabet("dna-n")).display() == (
        _narrow().display())


def test_chain_construction_is_the_scale_tests():
    """chip_smoke.chain_construction builds tests/test_chain_scale.py's pair."""
    comp = get_alphabet("dna-n").complement_array()
    n = 1500
    rng = np.random.default_rng(3000)
    ref = rng.integers(0, 4, size=n).astype(np.int8)
    qry = ref.copy()
    ts_sites = list(range(n // 20, n - 50, max(n // 10, 100)))
    for p in ts_sites:
        qry[p : p + 8] = [comp[c] for c in qry[p : p + 8]][::-1]
    snp_sites = [p for p in range(n // 40, n - 50, max(n // 100, 50))
                 if all(abs(p - t) > 60 for t in ts_sites)]
    for p in snp_sites:
        qry[p] = (qry[p] + 1) % 4
    got_r, got_q, expected, n_ts = chain_construction(n, 3000)
    np.testing.assert_array_equal(got_r, ref)
    np.testing.assert_array_equal(got_q, qry)
    assert (expected, n_ts) == (2 * len(ts_sites) + 2 * len(snp_sites), len(ts_sites))
    assert chain_construction(230000)[2:] == (216, 10)  # the reference scale's optimum


def test_chain_fixture_holds_the_smokes_pairs():
    with open(CHAIN_FIXTURE) as f:
        pairs = json.load(f)["pairs"]
    assert [p["name"] for p in pairs] == ["chain_1500", "chain_3000", "random_160"]
    for p in pairs:
        al = get_alphabet(p["alphabet"])
        if p["config"] == "narrow":
            ref, qry, expected, _ = chain_construction(len(p["reference"]), p["seed"])
            assert p["cost"] == expected
        else:
            cfg, ref, qry = _random_160()
            assert p["config"] == cfg.display()
        assert (al.decode(ref), al.decode(qry)) == (p["reference"], p["query"])
