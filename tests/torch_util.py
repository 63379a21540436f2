"""Shared fixtures and helpers of the port's tests (tests/test_torch_*.py)."""

import json
import os
import sys

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run torch on one thread: the port's CPU path is many small ops, and
    the suite runs several test processes side by side, whose thread pools
    would otherwise contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    """The CUDA device, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference_optimum(reference: str, query: str, base_cost=None):
    """(cost, the largest total template-switch length at that cost) of a
    pair under the default costs and the maximise tie-break, by the
    benchmark's plain reference (``portbench/reference/dp.py``, which shares
    no code with either package); `base_cost` replaces entries of the base
    costs (a cost of 2^28 or more is infinite there)."""
    sys.path.insert(0, os.path.join(ROOT, "portbench"))
    try:
        from reference import dp
    finally:
        sys.path.remove(os.path.join(ROOT, "portbench"))
    with open(os.path.join(ROOT, "portbench", "configs", "ts-default.json")) as f:
        costs = json.load(f)["costs"]
    costs["base_cost"].update(base_cost or {})
    return dp.solve(costs, reference, query, no_ts=False)


def cost_and_ts_length(res):
    """(cost, total template-switch length) of a record of the port."""
    return res.stats()["cost"], res.result.alignment.ts_total_length()
