"""pytest settings of the benchmark's own tests (`python -m pytest
benchmark/`): the harness's directory and the repository root on the path,
one torch thread, and the `card` marker of tests that need a CUDA card."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


@pytest.fixture(autouse=True, scope="session")
def _one_thread():
    import torch
    torch.set_num_threads(1)
