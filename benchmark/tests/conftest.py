"""The benchmark's tests: CPU tests at the port's tiny profile, and tests
marked `gpu` that need the card and skip without one.

    python -m pytest benchmark/tests -q            # here, on the CPU
    python -m pytest benchmark/tests -q -m gpu     # on the card
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    """The card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
