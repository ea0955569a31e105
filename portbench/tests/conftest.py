"""The benchmark's own tests: CPU tests at small sizes, and tests marked
``card`` that need an NVIDIA card and skip without one
(``python3 -m pytest portbench/tests -m card`` on the card's machine)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    """The CUDA device; skips the test without a card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's own size")
    return torch.device("cuda")
