"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from the
root of the repository (the `cuda` ones run on a machine with a card)."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

import pytest  # noqa: E402


@pytest.fixture
def card():
    """Skips a test marked `cuda` where torch sees no card (decided here, in
    the test, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda"
