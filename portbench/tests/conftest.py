"""The benchmark's own tests: `python -m pytest portbench/tests -q` from
the checkout's root (CPU, a tiny genome); `-m card` runs the one test
that needs a CUDA card, which decides in a fixture and skips without one."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cell runs only on the card")
    return torch
