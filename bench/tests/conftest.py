"""Tests of the benchmark harness.  They run on the CPU at small sizes,
through the program's plain paths; tests marked ``cuda`` need a card and
skip without one (decided inside the test).  Run them with

    PYTHONPATH=src python -m pytest -q bench/tests
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
