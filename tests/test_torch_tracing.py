"""The port's spans and counters (``tsalign_tpu_torch/tracing.py``) and its
one way across the host-device boundary (``ops.common.to_host`` /
``to_device``).

On the CPU: tracing is off by default and then records nothing; on, the
spans of one call share its id and nest inside their parents, a no-TS pair
records exactly the no-TS set of spans, a TS pair adds the reentry of each
round and kind and the traceback's module DPs, the engine-pass spans equal
the benchmark harness's count of passes, each call counts its engine passes,
its rounds and the rounds loops the k * delta stop ended, the traceback
counts the template switches it explains and the candidates it priced,
crossings on the CPU count nothing, and the command line's ``--profile``
trace shows the program's spans.

Marked `cuda` (this file imports no JAX, so they run on a machine with a
card): a 160 x 159 no-TS pair's reads and bytes are the ones its shapes
give; under ``torch.cuda.set_sync_debug_mode("error")``, relaxed only inside
the two helpers, a no-TS and a TS pair through ``align`` and a batch of TS
pairs through ``align_pairs`` on the fused and the host loop run through
(every synchronising crossing is a helper's); and each pair's sweep kernel runs between its
`engine.sweep` span's start and the end of the pair's next `device.read`
(the spans share the device trace's clock).

    python -m pytest tests/test_torch_tracing.py -m cuda -q -s
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import tsalign_tpu_torch
from tsalign_tpu_torch import cli, tracing
from tsalign_tpu_torch.ops import common

from torch_util import cuda, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CROSSINGS = {"device.reads", "copy.h2d_bytes", "copy.d2h_bytes"}
WITNESS = ("GAGCTTAAGCACAGGCCTGGGC", "GAGTGCTTAACAAGCCTGGGC")  # cost 4 by two switches, 13 bases

NOTS_SPANS = {"facade.call", "facade.settings", "facade.align", "facade.engine_pass",
              "engine.init", "rounds.align", "engine.seeds", "engine.tables", "engine.sweep",
              "engine.summary", "device.read", "traceback.trace", "record.postprocess",
              "record.result"}


def _planted(n, seed, stretch=10):
    """A random reference of n bases and a query with the reverse complement
    of `stretch` bases in place at n // 4 (a template switch explains it)."""
    rng = np.random.default_rng(seed)
    r = "".join(rng.choice(list("ACGT"), n))
    a = n // 4
    q = r[:a] + r[a:a + stretch][::-1].translate(str.maketrans("ACGT", "TGCA")) + r[a + stretch:]
    return r, q


def _twin(seed, n_r=160, n_q=159):
    rng = np.random.default_rng(seed)
    return ("".join(rng.choice(list("ACGT"), n_r)), "".join(rng.choice(list("ACGT"), n_q)))


@pytest.fixture
def traced():
    """Tracing on for one test, and off with nothing kept after it."""
    tracing.take()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.take()


def _align(kind, device="cpu", **kw):
    r, q = _planted(40, 1)
    return tsalign_tpu_torch.align(r, q, device=device, no_ts=kind == "nots", **kw)


def _crossings(counts):
    """The crossing counters of each call that has any."""
    out = {call: {k: v for k, v in per.items() if k in CROSSINGS} for call, per in counts.items()}
    return {call: per for call, per in out.items() if per}


def _passes(counts):
    """Each call's engine passes, rounds and k * delta stops."""
    return [{k: per.get(k) for k in ("facade.engine_passes", "rounds.rounds",
                                     "rounds.kdelta_stops")} for per in counts.values()]


def _inside(spans, i, name):
    """Whether span i lies under a span `name`."""
    parent = spans[i][3]
    while parent >= 0:
        if spans[parent][0] == name:
            return True
        parent = spans[parent][3]
    return False


def _check_nesting(spans):
    """Every span lies inside its parent and shares its call; each call has
    one root, a facade.call span."""
    roots = {}
    for name, a, b, parent, call, _ in spans:
        assert a <= b
        if parent < 0:
            assert call not in roots, "a call with two roots"
            roots[call] = name
            continue
        p = spans[parent]
        assert p[1] <= a and b <= p[2], (name, p[0])
        assert p[4] == call
    assert set(roots.values()) == {"facade.call"}
    return roots


# ---------------------------------------------------------------- CPU


@pytest.mark.parametrize("kind", ["nots", "ts"])
def test_off_by_default_nothing_is_recorded(kind):
    tracing.take()
    assert not tracing.enabled
    assert tracing.span("a") is tracing.span("b", x=1)
    _align(kind)
    assert tracing.take() == ([], {})


@pytest.mark.parametrize("kind", ["nots", "ts"])
def test_spans_of_one_call_share_its_id_and_nest(traced, kind):
    _align(kind)
    _align(kind)
    spans, counts = tracing.take()
    roots = _check_nesting(spans)
    assert len(roots) == 2 and _crossings(counts) == {}  # crossings on the CPU count nothing
    assert set(counts) == set(roots)
    assert tracing.take() == ([], {})


def test_a_nots_pair_records_the_nots_spans_and_no_crossing_on_the_cpu(traced):
    _align("nots")
    spans, counts = tracing.take()
    assert {s[0] for s in spans} == NOTS_SPANS
    assert _crossings(counts) == {}
    assert _passes(counts) == [{"facade.engine_passes": 1, "rounds.rounds": 1,
                                "rounds.kdelta_stops": 0}]
    reads = [s for s in spans if s[0] == "device.read"]
    assert all(spans[s[3]][0] in ("engine.summary", "traceback.trace", "engine.sweep")
               for s in reads)


@pytest.mark.parametrize("fused", [False, True])
def test_a_ts_pair_adds_reentry_and_module_spans(traced, fused):
    _align("ts", fused=fused)
    spans, counts = tracing.take()
    _check_nesting(spans)
    names = {s[0] for s in spans}
    assert NOTS_SPANS < names
    assert {"rounds.reentry", "traceback.module"} <= names
    reentry = [i for i, s in enumerate(spans) if s[0] == "rounds.reentry"]
    assert all(_inside(spans, i, "rounds.align") for i in reentry)
    assert all(_inside(spans, i, "rounds.fused") == fused for i in reentry)
    assert ("rounds.fused" in names) == fused
    control = [s[5] for s in spans if s[0] == "device.read" and "round" in s[5]]
    assert bool(control) == fused and all(a["round"] >= 1 for a in control)
    assert all(_inside(spans, i, "traceback.trace")
               for i, s in enumerate(spans) if s[0] == "traceback.module")
    assert _crossings(counts) == {}


@pytest.mark.parametrize("kind", ["nots", "ts"])
def test_engine_pass_spans_equal_the_harness_count(traced, kind):
    sys.path.insert(0, os.path.join(ROOT, "portbench"))
    try:
        from harness import trace as harness_trace
    finally:
        sys.path.remove(os.path.join(ROOT, "portbench"))
    tracer = harness_trace.Tracer()
    tracer.install()
    try:
        _align(kind)
    finally:
        tracer.uninstall()
    spans, _ = tracing.take()
    passes = [i for i, s in enumerate(spans) if s[0] == "facade.engine_pass"]
    assert len(passes) == tracer.passes[None] >= 1
    assert all(_inside(spans, i, "facade.align") for i in passes)


@pytest.mark.parametrize("fused", [False, True])
def test_rounds_and_passes_are_counted_on_the_witness(fused):
    """The witness's rounds loop runs to round 3, where its second template
    switch is found, and the TSLB stop ends it; an equal pair's ends at round
    1 by the k * delta stop.  Off, nothing is recorded."""
    tracing.take()
    tsalign_tpu_torch.align(*WITNESS, device="cpu", fused=fused)
    assert tracing.take() == ([], {})
    tracing.enable()
    try:
        res = tsalign_tpu_torch.align(*WITNESS, device="cpu", fused=fused)
        tsalign_tpu_torch.align(WITNESS[0], WITNESS[0], device="cpu", fused=fused)
    finally:
        tracing.disable()
    _, counts = tracing.take()
    assert res.stats()["template_switch_amount"] == 2
    assert _passes(counts) == [
        {"facade.engine_passes": 1, "rounds.rounds": 3, "rounds.kdelta_stops": 0},
        {"facade.engine_passes": 1, "rounds.rounds": 1, "rounds.kdelta_stops": 1}]


TSM_COUNTS = ("traceback.tsm_reconstructs", "traceback.tsm_candidates",
              "traceback.tsm_confirm_misses")


@pytest.mark.parametrize("fused", [False, True])
def test_the_tsm_search_is_counted_on_the_witness(traced, fused):
    """The traceback explains each of the witness's two template switches
    once, prices at least one candidate for each, and the forward column
    confirms the first hit every time; a no-TS record counts none of it."""
    res = tsalign_tpu_torch.align(*WITNESS, device="cpu", fused=fused)
    tsalign_tpu_torch.align(*WITNESS, device="cpu", no_ts=True)
    _, counts = tracing.take()
    ts, nots = ({k: per.get(k, 0) for k in TSM_COUNTS} for per in counts.values())
    assert ts["traceback.tsm_reconstructs"] == res.stats()["template_switch_amount"] == 2
    assert ts["traceback.tsm_candidates"] >= 2
    assert ts["traceback.tsm_confirm_misses"] == 0
    assert nots == dict.fromkeys(TSM_COUNTS, 0)


def test_align_pairs_is_one_call(traced):
    cfg = tsalign_tpu_torch.TemplateSwitchConfig.default(tsalign_tpu_torch.get_alphabet("dna-n"))
    recs = tsalign_tpu_torch.align_pairs(cfg, [_planted(32, 4, 8), _planted(28, 5, 8)],
                                         device="cpu")
    spans, counts = tracing.take()
    roots = _check_nesting(spans)
    assert len(recs) == 2 and len(roots) == 1 and _crossings(counts) == {}
    (per_call,) = counts.values()
    assert "facade.engine_passes" not in per_call  # one batched pass, no facade
    assert per_call["rounds.rounds"] >= 2 * 2 and per_call["rounds.kdelta_stops"] <= 2
    assert {"engine.seeds", "engine.sweep", "rounds.reentry", "traceback.trace"} <= {
        s[0] for s in spans}
    assert sum(s[0] == "traceback.trace" for s in spans) == 2


def test_helpers_count_only_crossings_off_the_cpu(traced):
    a = np.arange(12, dtype=np.int32).reshape(3, 4)
    on_cpu = common.to_device(a, "cpu")
    assert np.array_equal(common.to_host(on_cpu), a)
    spans, counts = tracing.take()
    assert [s[0] for s in spans] == ["device.read"] and spans[0][5] == {"numel": 12}
    assert counts == {}
    with tracing.span("root"):
        common.to_device(a.T, "meta")  # a device off the CPU that holds no data
        common.to_device([1, 2, 3], "meta")
    _, counts = tracing.take()
    assert list(counts.values()) == [{"copy.h2d_bytes": 12 * 4 + 3 * 8}]


def test_cli_profile_trace_shows_the_program_spans(tmp_path, capsys):
    r, q = _planted(24, 7, 6)
    pair = tmp_path / "pair.fa"
    pair.write_text(f">ref\n{r}\n>qry\n{q}\n")
    prof = tmp_path / "profile"
    assert cli.main(["align", "-p", str(pair), "--no-ts", "--device", "cpu",
                     "--profile", str(prof)]) == 0
    assert capsys.readouterr().out.startswith("cost: ")
    (trace,) = [p for p in prof.iterdir() if p.name.endswith(".pt.trace.json")]
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"engine.sweep", "facade.align", "traceback.trace"} <= names
    assert not tracing.enabled and tracing.take() == ([], {})


# ---------------------------------------------------------------- the card


def _nots_shapes(n_r, n_q, rows_per_fetch=64):
    """(reads, H2D bytes, D2H bytes) of a flankless no-TS pair on the card:
    the four sweep tables up, in one copy (the root seeds are made on the
    card); the entry layer, the target value and each 64-row block of the
    field the traceback walks through down."""
    rows, cols = n_r + 1, n_q + 1
    h2d = 4 * (rows * cols + rows * 2 + 2 * cols)
    blocks = -(-rows // rows_per_fetch)
    d2h = 4 * (rows * cols + 1 + 3 * rows * cols)
    return 2 + blocks, h2d, d2h


@pytest.mark.cuda
def test_a_nots_pair_counts_its_shapes_on_the_card(cuda, traced):
    tracing.disable()
    tsalign_tpu_torch.align(*_twin(1), device="cuda", no_ts=True)  # builds the kernels
    tracing.enable()
    tsalign_tpu_torch.align(*_twin(2), device="cuda", no_ts=True)
    _, counts = tracing.take()
    (per_call,) = _crossings(counts).values()
    reads, h2d, d2h = _nots_shapes(160, 159)
    assert (reads, h2d, d2h) == (5, 105_608, 412_164)
    assert per_call == {"device.reads": reads, "copy.h2d_bytes": h2d, "copy.d2h_bytes": d2h}


def _relaxed(helper):
    def run(*args, **kwargs):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return helper(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("error")
    return run


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["nots", "ts", "pairs_fused", "pairs_host"])
def test_every_synchronising_crossing_is_a_helpers(cuda, kind, monkeypatch):
    cfg = tsalign_tpu_torch.TemplateSwitchConfig.default(tsalign_tpu_torch.get_alphabet("dna-n"))

    def run(seed):
        """The records of one call: a pair through `align`, or four TS pairs
        of two lengths through `align_pairs` on the fused or the host loop."""
        if kind == "nots":
            return [tsalign_tpu_torch.align(*_twin(seed), device="cuda", no_ts=True).result]
        if kind == "ts":
            return [tsalign_tpu_torch.align(*_planted(96, seed, 16), device="cuda").result]
        pairs = [_planted(n, 4 * seed + i, 12) for i, n in enumerate((80, 90, 140, 150))]
        return tsalign_tpu_torch.align_pairs(cfg, pairs, device="cuda",
                                             fused=kind == "pairs_fused")

    run(11)
    torch.cuda.synchronize()
    helpers = {name: getattr(common, name) for name in ("to_host", "to_device")}
    for name, mod in list(sys.modules.items()):
        if name.startswith("tsalign_tpu_torch") and mod is not None:
            for helper, fn in helpers.items():
                if getattr(mod, helper, None) is fn:
                    monkeypatch.setattr(mod, helper, _relaxed(fn))
    torch.cuda.set_sync_debug_mode("error")
    try:
        # fresh pairs: their tables, bounds and kind modules are not memoised
        out = run(12)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out and all(rec.has_target for rec in out)


@pytest.mark.cuda
def test_sweep_kernels_lie_inside_their_spans(cuda, traced):
    from torch.autograd import DeviceType

    tracing.disable()
    tsalign_tpu_torch.align(*_twin(20), device="cuda", no_ts=True)
    torch.cuda.synchronize()
    tracing.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for seed in range(21, 41):
            tsalign_tpu_torch.align(*_twin(seed), device="cuda", no_ts=True)
        torch.cuda.synchronize()
    spans, _ = tracing.take()
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA and "sweep_kernel" in e.name())
    starts = [s[1] for s in spans if s[0] == "engine.sweep"]
    reads = [s for s in spans if s[0] == "device.read"]
    assert len(kernels) == len(starts) == 20
    worst = None
    for (k0, k1), s0 in zip(kernels, starts):
        read_end = min(s[2] for s in reads if s[1] >= s0)
        offset = max(s0 - k0, k1 - read_end)  # > 0: outside the window
        worst = offset if worst is None else max(worst, offset)
    print(f"sweep kernels against their spans: worst offset {worst / 1e3:.3f} us "
          f"(negative: inside)")
    assert worst <= 50_000
