"""control.py reads the check under the control and every fault that applies
and prints one line each; every line comes out not correct (at a size the
CPU holds; the chip runs it at the cells' own size)."""

import json

import pytest

import control
from harness import cells
from small import small_spec


@pytest.mark.parametrize("workload", ["ts-nomax.twin160-ts", "nots-default.twin160"])
def test_control_and_faults_are_not_correct(workload, monkeypatch, capsys):
    spec = small_spec(workload)
    monkeypatch.setattr(cells, "load", lambda name: spec)
    assert control.main(["--workload", workload, "--seeds", f"7,{2**31 + 1}",
                         "--seconds", "1"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert {x["fault"] for x in lines} >= {"control", "cost_off_by_one", "no_answer"}
    assert lines and not any(x["correct"] for x in lines), lines
