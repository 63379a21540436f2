"""The command: no card, no result; a missing piece, no result; no module of
JAX or of the JAX package loaded by a whole run (checked by top-level name,
as a whole word: the port's name begins with the JAX package's); nothing of
the benchmark imports them."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from harness import cells

RUN = os.path.join(cells.BENCH_DIR, "run.py")
FORBIDDEN = {"jax", "jaxlib", "flax", "tsalign_tpu"}


def run(args, cwd=cells.ROOT, env=None):
    return subprocess.run([sys.executable, RUN, *args], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_exits_nonzero_without_a_result(card_absent):
    r = run(["--workload", "nots-default.twin160", "--seed", str(2**31 + 3), "--seconds", "1",
             "--trace", "0"])
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_unknown_workload_exits_nonzero_without_a_result():
    r = run(["--workload", "no-such.cell", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(cells.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(cells.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "nots-default.twin160", "--seed", "5", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_a_whole_run_loads_no_forbidden_module():
    code = (
        "import sys, json; sys.path[:0] = [{bench!r}, {root!r}]\n"
        "from harness import bench\n"
        "from small import small_spec\n"
        "res = bench.run_cell('ts-nomax.twin160-ts', 9, 1.0, True, device='cpu',"
        " spec=small_spec('ts-nomax.twin160-ts'))\n"
        "print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))\n"
    ).format(bench=cells.BENCH_DIR, root=cells.ROOT)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(__file__))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    top = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert "tsalign_tpu_torch" in top and not (top & FORBIDDEN)


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(cells.BENCH_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                    mods = [node.module]
                else:
                    continue
                for m in mods:
                    assert m.split(".")[0] not in FORBIDDEN, (f, m)


@pytest.fixture
def card_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
