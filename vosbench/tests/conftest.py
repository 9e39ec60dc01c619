"""The benchmark's own tests: `python -m pytest vosbench/tests -q` from the
repository's root (the repository's `pytest tests/` does not collect them).
They run the harness on the CPU at tiny sizes through the program's plain
paths; tests marked `card` run on a CUDA card and skip elsewhere."""

import sys
from pathlib import Path

import pytest
import torch

CHECKOUT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(CHECKOUT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)
