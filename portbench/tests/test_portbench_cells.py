"""Every piece of every cell is found by name, and BENCHMARK.json keeps to
the benchmark's contract."""

import json
import os
import re

import pytest

from harness import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = cells.benchmark()
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    n = 24  # later PRs may add cells up to 24: a full check must still fit
    assert 1200 + (2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 2 * 90 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_pieces_found_by_name(workload):
    spec = cells.load(workload)
    cell = spec["cell"]
    assert workload == f"{cell['config']}.{cell['traffic']}"
    assert cell["chips"] == 1
    assert spec["config"]["name"] == cell["config"]
    assert spec["traffic"]["name"] == cell["traffic"]
    assert {m["name"] for m in spec["end_to_end"]} == {"pair_s", "setup_s"}
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert callable(cells.reader(m["name"]))


def test_names_units_and_metric_entries():
    names = [c["name"] for c in BENCH["configs"]] + WORKLOADS
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m["workloads"]) <= set(WORKLOADS) and m["workloads"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and c["source"].startswith("https://")
        assert os.path.isfile(os.path.join(cells.ROOT, c["file"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and "\n" not in w["why"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_reports_both_kinds_of_metric(workload):
    spec = cells.load(workload)
    assert any(m["name"] != "setup_s" for m in spec["end_to_end"])
    assert spec["per_layer"]


def test_missing_pieces_are_named():
    with pytest.raises(cells.Missing):
        cells.load("no-such.cell")
    with pytest.raises(cells.Missing):
        cells.reader("no_such_metric")


READERS = sorted(f[:-3] for f in os.listdir(os.path.join(cells.BENCH_DIR, "metrics"))
                 if f.endswith(".py"))
HOST_READERS = {"engine_passes", "rounds_per_pair", "rounds_self_s", "bound_s", "traceback_s",
                "record_s"}


def test_every_reader_reads_a_traced_run_on_the_cpu():
    """The readers of the template-switch layers, kept for the cell that brings
    them back into BENCHMARK.json, read a traced template-switch run; those of
    device numbers find nothing on the CPU and return nothing."""
    from harness import bench
    from small import small_spec

    spec = small_spec("ts-nomax.twin160-ts")
    spec["per_layer"] = [{"name": n, "unit": "-"} for n in READERS]
    res = bench.run_cell("ts-nomax.twin160-ts", 2**31 + 17, 2.0, True, device="cpu", spec=spec)
    assert res["correct"], res["compared"]
    assert HOST_READERS <= set(res["metrics"]) <= set(READERS)
    assert all(res["metrics"][n]["value"] > 0 for n in HOST_READERS)
