"""A cell's pieces with the traffic cut to a size the CPU runs in seconds
(the plain torch versions of the port's kernels are what runs there), and
the pieces of a cell that BENCHMARK.json does not name."""

import json
import os

from harness import cells

SMALL = {"length": 36, "margin": 6, "stretches": [{"count": 1, "length": 8}], "pool": 1000,
         "warmup_calls": 1}


def small_spec(workload):
    """The cell's pieces, from BENCHMARK.json or, for a cell that it does not
    name, from the files of `<config>.<traffic>`."""
    try:
        spec = cells.load(workload)
    except cells.Missing:
        return small_spec_of(*workload.split(".", 1))
    spec["traffic"] = dict(spec["traffic"], **SMALL)
    return spec


def config(name):
    with open(os.path.join(cells.BENCH_DIR, "configs", name + ".json")) as f:
        return json.load(f)


def traffic(name):
    with open(os.path.join(cells.BENCH_DIR, "traffic", name + ".json")) as f:
        return json.load(f)


def small_spec_of(config_name, traffic_name):
    """The pieces of `<config>.<traffic>` from their files, for a cell that
    BENCHMARK.json does not name (its per-layer metrics: none)."""
    t = traffic(traffic_name)
    name = f"{config_name}.{traffic_name}"
    return {"cell": {"name": name, "config": config_name, "traffic": traffic_name, "chips": 1},
            "config": config(config_name), "traffic": dict(t, **SMALL), "end_to_end": [],
            "per_layer": []}
