"""The cell `ts-default.twin160-ts` at a size the CPU runs: a run is
correct, its eleven per-layer readers return numbers, and the check counts a
record whose total template-switch length is short."""

import pytest

from harness import bench, cells, check, trace
from reference import dp
from small import config, small_spec

CELL = "ts-default.twin160-ts"
READERS = ["rounds_per_pair", "rounds_self_s", "bound_s", "module_scan_roofline",
           "assembly_roofline", "ts_engine_passes", "ts_traceback_s", "ts_device_idle_share",
           "ts_peak_mem_gib", "ts_pair_p95_s", "ts_record_s"]
# what a short traced run on the CPU reads: the rooflines, the idle share and
# the peak memory read the card, and the tail needs twenty pairs
HOST_READERS = ["rounds_per_pair", "rounds_self_s", "bound_s", "ts_engine_passes",
                "ts_traceback_s", "ts_record_s"]
# the pair that the k * delta stop once cut short: cost 4, the longest
# total template-switch length at that cost 13, one template switch 8
WITNESS = ("GAGCTTAAGCACAGGCCTGGGC", "GAGTGCTTAACAAGCCTGGGC")


@pytest.fixture(scope="module")
def traced():
    return bench.run_cell(CELL, 2**31 + 29, 2.0, True, device="cpu", spec=small_spec(CELL))


def test_the_cell_names_its_eleven_readers():
    spec = cells.load(CELL)
    assert [m["name"] for m in spec["per_layer"]] == READERS
    assert {m["name"] for m in spec["end_to_end"]} == {"pair_s", "setup_s"}
    assert spec["cell"]["chips"] == 1 and spec["config"]["name"] == "ts-default"


def test_an_untraced_run_is_correct():
    res = bench.run_cell(CELL, 2**31 + 7, 2.0, False, device="cpu", spec=small_spec(CELL))
    assert res["correct"], res["compared"]
    assert res["compared"]["ts_length_short"] == {"value": 0, "limit": 0}
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"pair_s", "setup_s"}


def test_a_traced_run_is_correct_and_its_host_readers_read_numbers(traced):
    assert traced["correct"], traced["compared"]
    assert set(HOST_READERS) <= set(traced["metrics"])
    for name in HOST_READERS:
        assert traced["metrics"][name]["value"] > 0, name
    assert traced["metrics"]["ts_engine_passes"]["value"] == 1.0
    assert traced["metrics"]["rounds_per_pair"]["value"] >= 2


@pytest.mark.parametrize("name", READERS)
def test_each_reader_returns_a_number(name):
    """Each reader on a run that holds what it reads (the rooflines' device
    time, the idle share and the peak memory exist only on the card, so they
    are given here)."""
    spans = [("rounds.align", 0, 3_000, 0), ("bounds.remaining_bound", 1_000, 2_000, 0),
             ("traceback.trace", 4_000, 9_000, 0), ("traceback.trace", 10_000, 12_000, 1),
             ("record.postprocess", 12_000, 12_500, 1)]
    run = bench.Run(
        n_pairs=2, walls=[0.5] * 19 + [0.7], passes={0: 1, 1: 1}, rounds={0: [4], 1: [5]},
        spans=spans, kernel_s={trace.SCAN_KERNEL: 2e-3, trace.ASSEMBLY_KERNEL: 1e-3},
        scan_least_s=5e-4, asm_least_s=4e-5, busy_s=0.5, window_s=2.0, peak_bytes=2**29,
        self_seconds=lambda span: trace.self_seconds(spans, span))
    expected = {"rounds_per_pair": 4.5, "rounds_self_s": 1e-6, "bound_s": 5e-7,
                "module_scan_roofline": 25.0, "assembly_roofline": 4.0, "ts_engine_passes": 1.0,
                "ts_traceback_s": 3.5e-6, "ts_device_idle_share": 75.0, "ts_peak_mem_gib": 0.5,
                "ts_pair_p95_s": 0.69, "ts_record_s": 2.5e-7}
    assert cells.reader(name)(run) == pytest.approx(expected[name])


def test_a_short_record_counts_as_ts_length_short():
    """One template switch where two reach the same cost: the cost and the
    alignment are right, the total template-switch length is short."""
    from tsalign_tpu_torch import Aligner

    cfg = config("ts-default")
    want = dp.solve(cfg["costs"], *WITNESS, no_ts=False)
    assert want == (4, 13)
    full = Aligner(device="cpu").align(*WITNESS)
    short = Aligner(device="cpu").align(*WITNESS, max_template_switches=1)
    assert short.result.alignment.ts_total_length() == 8
    compared, _ = check.judge(cfg, [WITNESS] * 2, [full, short], [want] * 2, failed=0)
    assert compared["ts_length_short"] == {"value": 1, "limit": 0}
    assert compared["cost_wrong"]["value"] == compared["alignment_wrong"]["value"] == 0
