"""Shared set-up of the benchmark's own tests (CPU, small widths).

Run from the repository root: ``python -m pytest portbench/tests -q``.
Tests that need a CUDA card carry the ``card`` marker and skip without
one; on the card: ``python -m pytest portbench/tests -q -m card``.
"""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the benchmark measures the port on one)")
    return torch.device("cuda")
