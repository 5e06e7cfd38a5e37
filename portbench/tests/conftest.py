"""The benchmark folder's own tests (``pytest portbench/tests``): on the CPU,
at tiny sizes, with the program's plain kernel versions. Tests marked
``cuda`` need a card; whether there is one is decided in the ``card``
fixture when a test runs, never while a module is imported."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)
