"""CPU tests of the port's benchmark harness.  They import neither JAX nor
the JAX package; tests marked ``cuda`` need a card and skip without one."""

import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """Skip the test without a CUDA device (decided when it runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
