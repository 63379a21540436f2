"""A run on the CPU (the harness's look for a card skipped, everything else
as on the card) with the timed path broken underneath sees `correct` come
out false, once for each fault that the cell can have and under the check's
control (portbench/faults.py); unbroken, it is correct.  A window that
outruns its pool makes pairs with its clock stopped."""

import pytest

import faults
from harness import bench
from small import small_spec

SEED = 2**31 + 4242
CELLS = ["ts-nomax.twin160-ts", "nots-default.twin160"]
CASES = [(w, f) for w in CELLS for f in faults.FAULTS
         if faults.applies(f, small_spec(w)["config"])]


def run(workload, spec=None):
    return bench.run_cell(workload, SEED, 2.0, False, device="cpu",
                          spec=spec or small_spec(workload))


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    res = run(workload)
    assert res["correct"], res["compared"]
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("workload,fault", CASES, ids=[f"{w}-{f}" for w, f in CASES])
def test_fault_is_not_correct(workload, fault):
    spec = small_spec(workload)
    with faults.planted(fault, spec["config"]):
        res = run(workload, spec)
    assert not res["correct"], res["compared"]


def test_control_applies_to_every_cell():
    assert all(faults.applies("control", small_spec(w)["config"]) for w in CELLS)


def test_pairs_made_in_the_window_are_not_timed():
    spec = small_spec("nots-default.twin160")
    spec["traffic"]["pool"] = 2
    res = run("nots-default.twin160", spec)
    host = res["host"]
    assert res["correct"] and res["attempted"] > 2
    assert host["pairs_made_in_window"] > 0 and host["made_in_window_s"] > 0
    assert host["window_s"] == pytest.approx(sum(p["wall_s"] for p in res["pairs"]), rel=0.2)
