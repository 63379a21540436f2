"""A short run of every cell on the card, untraced and traced: exit 0, the
result line's keys in order, `correct`, the cell's metrics, a busy device
and rooflines that stay under 105 %.  Marked `cuda`: skipped without a card."""

import json
import os
import subprocess
import sys

import pytest

from harness import cells

WORKLOADS = [w["name"] for w in cells.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_short_run_on_the_card(card, workload, traced):
    r = subprocess.run(
        [sys.executable, os.path.join(cells.BENCH_DIR, "run.py"), "--workload", workload,
         "--seed", str(2**31 + 99), "--seconds", "3", "--trace", str(traced)],
        cwd=cells.ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["attempted", "failed", "correct", "metrics", "device"]
    assert list(res)[-1] == "compared"
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    spec = cells.load(workload)
    if not traced:
        assert set(res["metrics"]) == {m["name"] for m in spec["end_to_end"]}
        return
    assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] > 0
    want = {m["name"] for m in spec["per_layer"]} - {"pair_p95_s"}  # p95 needs 20 pairs
    assert want <= set(res["metrics"])
    for name, m in res["metrics"].items():
        if name.endswith("_roofline"):
            assert 0 < m["value"] <= 105
    assert res["breakdown"]["device_ops"] and res["breakdown"]["idle_gaps"]
