"""Finds a cell's pieces by name: the cell in BENCHMARK.json at the root of
the checkout, its configuration in ``portbench/configs/<config>.json``, its
traffic in ``portbench/traffic/<traffic>.json`` and each per-layer metric's
reader in ``portbench/metrics/<metric>.py``.  A later cell, configuration,
traffic mix or metric is added as files and entries; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class Missing(LookupError):
    pass


def _json(path: str) -> dict:
    if not os.path.isfile(path):
        raise Missing(f"{os.path.relpath(path, ROOT)} is not there")
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def load(workload: str, bench: dict | None = None) -> dict:
    """{"cell", "config", "traffic", "end_to_end", "per_layer"} of a cell:
    the metrics are the entries that name the cell, or name no cells."""
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Missing(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    if cell["config"] not in configs:
        raise Missing(f"no configuration {cell['config']!r} in BENCHMARK.json")
    config = _json(os.path.join(ROOT, configs[cell["config"]]["file"]))
    traffic = _json(os.path.join(BENCH_DIR, "traffic", cell["traffic"] + ".json"))

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": mine(bench["end_to_end"]), "per_layer": mine(bench["per_layer"])}


def reader(metric: str):
    """The `read(run)` function of a per-layer metric's reader."""
    path = os.path.join(BENCH_DIR, "metrics", metric + ".py")
    if not os.path.isfile(path):
        raise Missing(f"no reader portbench/metrics/{metric}.py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + metric.replace(".", "_")
                                                  .replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
